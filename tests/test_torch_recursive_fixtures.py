"""The toy recursive chains of the recursive fixtures
(tests/data/torch_toy_recursive{,_oracle}_ref.json.gz): the reference tests'
step z -> z^3 + 7 on Pasta, with real commitments or with the tests'
commitment oracle. The reference side imports the JAX package inside its
functions; the port side imports no JAX. It holds no test: the port's
recursive tests, the card tests and chip_smoke.py's phase 10 import it."""

import contextlib
import gzip
import hashlib
import json
import os

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
LABEL = b"test-recursive"
CHAINS = {"toy": (False, 2), "oracle": (True, 3)}   # (oracle, n_steps)
Z0 = [5]


def toy_gadget(ctx, z_prev, extra, gadgets=None):
    sq = gadgets.mul(ctx, z_prev[0], z_prev[0], name="sq")
    cube = gadgets.mul(ctx, sq, z_prev[0], name="cube")
    return [cube + 7]


def toy_host(q):
    return lambda z: [(pow(z[0], 3, q) + 7) % q]


def ref_path(name: str) -> str:
    suffix = "" if name == "toy" else "_oracle"
    return os.path.join(DATA, f"torch_toy_recursive{suffix}_ref.json.gz")


def load_ref(name: str) -> dict:
    with gzip.open(ref_path(name), "rt") as f:
        return json.load(f)


@contextlib.contextmanager
def oracle_commits(snark, C):
    """The reference tests' commitment oracle: commit(v) = (sum v_i k_i)·G
    with k_i = sha256("k%d" % i) mod q, homomorphic like Pedersen, one host
    scalar multiplication; C is either package's ops.curve."""
    import numpy as np
    try:
        for side in (snark.side1, snark.side2):
            G = C.derive_generators(side.curve, b"fake-commit", 1)[0]
            q = side.curve.scalar.p
            ks = [int.from_bytes(hashlib.sha256(b"k%d" % i).digest(),
                                 "little") % q
                  for i in range(side.shape.n_vars)]

            def commit(vec_canon, _side=side, _G=G, _ks=ks, _q=q):
                vals = _side.spec.limbs_to_ints(np.asarray(vec_canon))
                s_ = sum(int(v) * k for v, k in zip(vals, _ks)) % _q
                return C.host_scalar_mul(_side.curve, s_, _G)

            side.commit = commit
        yield
    finally:
        for side in (snark.side1, snark.side2):
            side.__dict__.pop("commit", None)


def port_snark(curves=("pallas", "vesta"), label: bytes = LABEL,
               device="cpu"):
    """The port's RecursiveSNARK of the toy step on the cycle `curves`."""
    from hotproofs_tpu_torch.circuits import gadgets as g
    from hotproofs_tpu_torch.nova import recursive as R
    from hotproofs_tpu_torch.ops import curve as C
    cycle = tuple(C.CURVES[c] for c in curves)
    return R.RecursiveSNARK(
        lambda ctx, z, extra: toy_gadget(ctx, z, extra, g),
        toy_host(cycle[0].scalar.p), arity=1, label=label, cycle=cycle,
        device=device)


def make_reference(name: str) -> dict:
    """The JAX package's proof of chain `name`, as RecursiveProof.to_dict."""
    from hotproofs_tpu.circuits import gadgets as g
    from hotproofs_tpu.nova import recursive as R
    from hotproofs_tpu.ops import curve as C
    oracle, n_steps = CHAINS[name]
    snark = R.RecursiveSNARK(
        lambda ctx, z, extra: toy_gadget(ctx, z, extra, g),
        toy_host(C.PALLAS.scalar.p), arity=1, label=LABEL)
    ctx = oracle_commits(snark, C) if oracle else contextlib.nullcontext()
    with ctx:
        proof = snark.prove(Z0, n_steps=n_steps)
        snark.verify(proof)
    return proof.to_dict()


def compressed_path() -> str:
    return os.path.join(DATA, "torch_toy_recursive_compressed.json.gz")


def make_port_compressed(device="cuda") -> str:
    """The port's compressed proof of the reference's toy chain with real
    commitments (the saved file's text), verified by the port."""
    import tempfile

    from hotproofs_tpu_torch.nova import recursive as R
    snark = port_snark(device=device)
    proof = R.RecursiveProof.from_dict(load_ref("toy"))
    cp = snark.compress(proof)
    assert snark.verify_compressed(cp) == proof.z_final
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cp.json")
        cp.save(path)
        with open(path) as f:
            return f.read()


def reference_verifies_compressed() -> list:
    """The JAX package's RecursiveSNARK of the toy chain (its real keys)
    verifies the port's committed compressed proof; returns z_final."""
    import tempfile

    from hotproofs_tpu.circuits import gadgets as g
    from hotproofs_tpu.nova import recursive as R
    from hotproofs_tpu.ops import curve as C
    snark = R.RecursiveSNARK(
        lambda ctx, z, extra: toy_gadget(ctx, z, extra, g),
        toy_host(C.PALLAS.scalar.p), arity=1, label=LABEL)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cp.json")
        with gzip.open(compressed_path(), "rt") as f, open(path, "w") as g_:
            g_.write(f.read())
        return snark.verify_compressed(R.CompressedRecursiveProof.load(path))


PARTS = ("hashes", "sp1", "sp2", "sp_u1")


def reference_verifies_compressed_part(part: str) -> None:
    """One part of the JAX package's verify_compressed on the port's
    committed compressed proof, so that each can run in its own process:
    'hashes' (the two state-hash bindings of u1) or 'sp1', 'sp2', 'sp_u1'
    (the Spartan verify_relaxed of U1, U2 and the strict u1). sp1 and sp_u1
    share side 1's table cache (.cache/spartanH_*): run sp_u1 after sp1."""
    from hotproofs_tpu.circuits import gadgets as g
    from hotproofs_tpu.nova import recursive as R
    from hotproofs_tpu.ops import curve as C
    assert part in PARTS, part
    snark = R.RecursiveSNARK(
        lambda ctx, z, extra: toy_gadget(ctx, z, extra, g),
        toy_host(C.PALLAS.scalar.p), arity=1, label=LABEL)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cp.json")
        with gzip.open(compressed_path(), "rt") as f, open(path, "w") as g_:
            g_.write(f.read())
        cp = R.CompressedRecursiveProof.load(path)
    if part == "hashes":
        q = snark.q
        z0 = [int(v) % q for v in cp.z0]
        z_final = [int(v) % q for v in cp.z_final]
        h1 = R.state_hash_host(snark.pspec1, snark.vk, cp.n_steps, z0,
                               z_final, cp.U2)
        assert cp.u1.X[0] == h1, "primary state hash mismatch"
        h2 = R.state_hash_host(snark.pspec2, snark.vk, cp.n_steps, None,
                               None, cp.U1)
        assert cp.u1.X[1] == h2, "secondary state hash mismatch"
        return
    i1, i2, iu = snark._instances(cp)
    side, inst, sp = {"sp1": (snark.side1, i1, cp.sp1),
                      "sp2": (snark.side2, i2, cp.sp2),
                      "sp_u1": (snark.side1, iu, cp.sp_u1)}[part]
    snark._spartan(side).verify_relaxed(inst, sp)


if __name__ == "__main__":
    # python tests/test_torch_recursive_fixtures.py {toy,oracle} OUT.json.gz
    # (JAX_PLATFORMS=cpu PYTHONPATH=. ; the real-commitment chain compiles
    # the reference's MSM on XLA:CPU, tens of minutes per width), or
    # python tests/test_torch_recursive_fixtures.py compressed OUT.json.gz
    # on the card (PYTHONPATH=.; the port's compression of the toy one), or
    # python tests/test_torch_recursive_fixtures.py verify-compressed
    # (JAX_PLATFORMS=cpu PYTHONPATH=.; the reference's verdict on it, hours
    # of XLA:CPU compiles), or ... verify-compressed-part PART, one part of
    # that verdict (PARTS) in its own process
    import sys
    import time
    if sys.argv[1] == "verify-compressed-part":
        # ... verify-compressed-part {hashes,sp1,sp2,sp_u1}: one part of the
        # verdict; a stack dump every 10 minutes says where a cut run stood
        import faulthandler
        faulthandler.dump_traceback_later(600, repeat=True)
        t0 = time.perf_counter()
        reference_verifies_compressed_part(sys.argv[2])
        print("part", sys.argv[2], "accepted",
              f"{time.perf_counter() - t0:.0f} s", flush=True)
    elif sys.argv[1] == "verify-compressed":
        t0 = time.perf_counter()
        print("z_final", reference_verifies_compressed(),
              f"{time.perf_counter() - t0:.0f} s", flush=True)
    elif sys.argv[1] == "compressed":
        text = make_port_compressed()
        with gzip.open(sys.argv[2], "wt") as f:
            f.write(text)
    else:
        doc = make_reference(sys.argv[1])
        with gzip.open(sys.argv[2], "wt") as f:
            json.dump(doc, f)
