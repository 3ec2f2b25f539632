"""Matrix tables with h_tables' edge rows, for the CPU tests of the
kernel's host replay (test_torch_cuda_host.py) and the card tests
(test_torch_cuda_kernels.py)."""

import torch

from hotproofs_tpu_torch.ops import field as F
from hotproofs_tpu_torch.ops import tables as TB


def edge_tables(spec, n, rng):
    """A CSR over an n-generator key with h_tables' edge rows: empty rows
    (first, middle, last), a row of one digit (the value 7), a row of one
    small and one full-width value, a row of 259 full-width negated values
    (each p - r, r < p / 2, so its mag is r and every point is negated),
    rows of a few small values of one digit value (all lanes on it), and
    seeded rows of random values. -> (csr, rows, cols, vals)."""
    fs = spec.scalar
    rows, cols, vals = [], [], []

    def row(r, vs):
        for v in vs:
            rows.append(r)
            cols.append(int(rng.integers(0, n)))
            vals.append(v % fs.p)

    full = lambda: int.from_bytes(rng.bytes(32), "little") % (fs.p // 2)
    row(1, [7])
    row(2, [3, full()])
    row(4, [fs.p - full() for _ in range(259)])
    row(5, [1] * 40)
    row(6, [0x11, 0x1111, 1 << 100])
    for r in range(7, 14):
        row(r, [full() if rng.random() < 0.5 else int(rng.integers(1, 99))
                for _ in range(int(rng.integers(1, 12)))])
    R = 15                                  # rows 0, 3 and 14 empty
    mont = F.to_h16(F.to_mont(fs, F.from_ints(fs, vals)))
    csr = TB.table_csr(fs, [(torch.tensor(rows), torch.tensor(cols),
                             mont)], R)
    return csr, rows, cols, vals
