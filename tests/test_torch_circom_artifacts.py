"""The port's copy of the circom artifact parsers
(hotproofs_tpu_torch.core.circom_artifacts) against the reference's: each
package's .r1cs writer is read by the other's parser to equal objects, the
two writers give the same bytes, and both refuse bad magic and truncation
alike. The cases over the reference's recorded build artifacts skip, as
tests/test_circom_artifacts.py does, when those are not mounted."""

import os
import struct

import pytest

from hotproofs_tpu.core import circom_artifacts as RA
from hotproofs_tpu_torch.core import blake3_ref as b3
from hotproofs_tpu_torch.core import circom_artifacts as CA
from test_circom_artifacts import BN254_PRIME, REF

needs_ref = pytest.mark.skipif(
    not os.path.exists(REF), reason="reference artifacts not mounted")


def _r1cs(mod, labels: bool):
    """A small constraint system: a product, a sum with a negative
    coefficient (reduced by the writer), an empty linear combination."""
    return mod.R1CS(
        prime=BN254_PRIME, n_wires=6, n_pub_out=1, n_pub_in=2, n_prv_in=1,
        n_labels=9,
        constraints=[
            ([(1, 1)], [(2, 1)], [(3, 1)]),
            ([(3, 2), (0, 5)], [(4, BN254_PRIME - 1)], []),
            ([(5, (1 << 253) + 7)], [(0, 1)], [(2, 3), (1, 4), (5, 1)]),
        ],
        wire_to_label=[0, 1, 2, 5, 6, 8] if labels else None)


def _fields(r):
    return (r.prime, r.n_wires, r.n_pub_out, r.n_pub_in, r.n_prv_in,
            r.n_labels, r.constraints, r.wire_to_label)


@pytest.mark.parametrize("labels", [True, False])
@pytest.mark.parametrize("writer,reader", [(CA, RA), (RA, CA), (CA, CA)],
                         ids=["port-to-reference", "reference-to-port",
                              "port-to-port"])
def test_r1cs_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                        reader, labels):
    path = str(tmp_path / "toy.r1cs")
    writer.write_r1cs(path, _r1cs(writer, labels))
    back = reader.parse_r1cs(path)
    assert isinstance(back, reader.R1CS)
    assert _fields(back) == _fields(_r1cs(reader, labels))


@pytest.mark.parametrize("n8", [32, 40])
def test_writers_give_the_same_bytes(tmp_path, n8):
    ours, ref = str(tmp_path / "a.r1cs"), str(tmp_path / "b.r1cs")
    CA.write_r1cs(ours, _r1cs(CA, True), n8=n8)
    RA.write_r1cs(ref, _r1cs(RA, True), n8=n8)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def _wtns(path, magic=b"wtns", version=2, values=(1, 5, 7), n8=32,
          cut=0):
    hdr = struct.pack("<I", n8) + BN254_PRIME.to_bytes(n8, "little") + \
        struct.pack("<I", len(values))
    body = b"".join(v.to_bytes(n8, "little") for v in values)
    data = magic + struct.pack("<II", version, 2) + \
        struct.pack("<IQ", 1, len(hdr)) + hdr + \
        struct.pack("<IQ", 2, len(body)) + body
    with open(path, "wb") as f:
        f.write(data[:len(data) - cut])
    return path


def test_wtns_and_sym_parse_alike(tmp_path):
    w = _wtns(str(tmp_path / "w.wtns"))
    ours, ref = CA.parse_wtns(w), RA.parse_wtns(w)
    assert (ours.prime, ours.values, len(ours)) == \
        (ref.prime, ref.values, len(ref)) == (BN254_PRIME, [1, 5, 7], 3)
    sym = tmp_path / "c.sym"
    sym.write_text("1,1,0,main.out\n2,-1,0,main.tmp\n\n3,2,1,main.sub.x\n")
    a, b = CA.parse_sym(str(sym)), RA.parse_sym(str(sym))
    assert [vars(e) for e in a.entries] == [vars(e) for e in b.entries]
    assert a.n_signals == b.n_signals == 3
    assert a.witness_index("main.sub.x") == b.witness_index("main.sub.x")
    for table in (a, b):
        with pytest.raises(KeyError):
            table.witness_index("main.tmp")       # optimized out


@pytest.mark.parametrize("case,match", [
    ({"magic": b"nope"}, "magic"), ({"version": 3}, "version"),
    ({"cut": 1}, "truncated"), ({"cut": 40}, "truncated"),
    ({"values": (1, 2), "cut": 0, "n8": 32}, None)])
def test_bad_files_raise_alike(tmp_path, case, match):
    path = _wtns(str(tmp_path / "bad.wtns"), **case)
    if match is None:                 # a well-formed file parses in both
        assert CA.parse_wtns(path).values == RA.parse_wtns(path).values
        return
    for mod in (CA, RA):
        with pytest.raises(ValueError, match=match):
            mod.parse_wtns(path)
    r = str(tmp_path / "bad.r1cs")
    with open(path, "rb") as f:
        data = f.read()
    with open(r, "wb") as f:
        f.write(b"r1cs" + data[4:] if match != "magic" else data)
    for mod in (CA, RA):
        with pytest.raises(ValueError, match=match):
            mod.parse_r1cs(r)


def test_trailing_bytes_after_constraints_raise_alike(tmp_path):
    path = str(tmp_path / "t.r1cs")
    CA.write_r1cs(path, _r1cs(CA, False))
    with open(path, "rb") as f:
        data = bytearray(f.read())
    # grow section 2 by 4 bytes of zeros inside its declared length
    hdr_len = struct.unpack_from("<Q", data, 16)[0]
    off = 12 + 12 + hdr_len
    sid, slen = struct.unpack_from("<IQ", data, off)
    assert sid == 2
    struct.pack_into("<IQ", data, off, sid, slen + 4)
    data[off + 12 + slen:off + 12 + slen] = b"\0" * 4
    with open(path, "wb") as f:
        f.write(bytes(data))
    for mod in (CA, RA):
        with pytest.raises(ValueError, match="trailing"):
            mod.parse_r1cs(path)


@pytest.fixture(scope="module")
def sym():
    return CA.parse_sym(os.path.join(REF, "blake3_compression.sym"))


@pytest.fixture(scope="module")
def wtns():
    return CA.parse_wtns(os.path.join(REF, "testInp", "witness.wtns"))


@needs_ref
def test_reference_artifacts_parse_alike(sym, wtns):
    assert sym.n_signals == 69380
    ref_sym = RA.parse_sym(os.path.join(REF, "blake3_compression.sym"))
    assert [vars(e) for e in sym.entries] == \
        [vars(e) for e in ref_sym.entries]
    ref_w = RA.parse_wtns(os.path.join(REF, "testInp", "witness.wtns"))
    assert (wtns.prime, wtns.values) == (ref_w.prime, ref_w.values)


@needs_ref
def test_recorded_inputs_reproduce_recorded_outputs(sym, wtns):
    """The recorded witness's inputs through the port's BLAKE3 oracle give
    its recorded outputs."""
    def sig(name):
        return wtns.values[sym.witness_index(name)]

    h = [sig(f"main.h[{i}]") for i in range(8)]
    m = [sig(f"main.m[{i}]") for i in range(16)]
    t = sig("main.t[0]") | (sig("main.t[1]") << 32)
    got = b3.compress(h, m, t, sig("main.b"), sig("main.d"))
    assert got == [sig(f"main.out[{i}]") for i in range(16)]
