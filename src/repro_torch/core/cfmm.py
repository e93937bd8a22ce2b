"""Common Factor Mass Multiplication (CFMM) — paper SS II-E.1 (ports
``repro/core/cfmm.py``).

The paper's counting argument:

* an INT7 weight magnitude lies in [0, 63];
* the **sign** moves into the adder tree, equivalence-classing +/-w
  (128 -> 64 unique values);
* **even** products are a (free) left shift of an **odd** product, so only
  the 32 odd magnitudes {1, 3, ..., 63} need computing.

So one input activation (the *common factor*) needs at most 32 unique
products to serve every weight that multiplies it.  Everything here is
exact integer arithmetic in plain PyTorch, on any device: the products
that reach int32 sums go through ``kernels.ref.int8_matmul_ref`` (float64,
exact for every sum these shapes reach), never through ``int8 @ int8``,
which wraps.  The ``cfmm`` serve mode's matmul runs the CUDA kernel of
``kernels/cfmm_matmul.py``; ``bitserial_matmul`` is the ``bitserial``
mode's head and stays plain, as it is plain JAX in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quantize import INT7_MAX
from repro_torch.kernels.ref import int8_matmul_ref

# The 32 unique odd magnitudes of INT7.
ODD_VALUES = np.arange(1, INT7_MAX + 1, 2)          # [1, 3, ..., 63]
N_UNIQUE_PRODUCTS = len(ODD_VALUES)                  # == 32

# LUTs over |q| in [0, 63]: |q| = odd(mag_idx) << shift, with mag_idx in
# [0, 32) and shift in [0, 5].  Entry 0 is a don't-care (zero weight).
_MAG_IDX_LUT = np.zeros(INT7_MAX + 1, np.int8)
_SHIFT_LUT = np.zeros(INT7_MAX + 1, np.int8)
for _m in range(1, INT7_MAX + 1):
    _v, _s = _m, 0
    while _v % 2 == 0:
        _v //= 2
        _s += 1
    _MAG_IDX_LUT[_m] = (_v - 1) // 2
    _SHIFT_LUT[_m] = _s
MAX_SHIFT = int(_SHIFT_LUT.max())                    # == 5


@dataclasses.dataclass
class CFMMWeights:
    """Packed constant-parameter form of an INT7 weight tensor.

    sign    in {-1, 0, +1}  (0 encodes a pruned/zero weight)
    mag_idx in [0, 32)      index into ODD_VALUES
    shift   in [0, 5]       left shift applied to the odd product
    scale   per-output-channel dequant scale (f32)

    reconstruct(): sign * (ODD_VALUES[mag_idx] << shift) == original int7.
    """

    sign: torch.Tensor      # int8
    mag_idx: torch.Tensor   # int8
    shift: torch.Tensor     # int8
    scale: torch.Tensor     # f32

    @property
    def shape(self):
        return self.sign.shape


def _lut(table: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(table).to(device)


def decompose(q: torch.Tensor):
    """INT7 codes -> (sign, mag_idx, shift), all int8.  Exact for
    |q| <= 63."""
    sign = torch.sign(q).to(torch.int8)
    mag = torch.abs(q.to(torch.int32)).long()
    return (sign, _lut(_MAG_IDX_LUT, q.device)[mag],
            _lut(_SHIFT_LUT, q.device)[mag])


def reconstruct(sign: torch.Tensor, mag_idx: torch.Tensor,
                shift: torch.Tensor) -> torch.Tensor:
    """(sign, mag_idx, shift) -> int32 codes."""
    odd = torch.from_numpy(ODD_VALUES.astype(np.int32)).to(
        mag_idx.device)[mag_idx.long()]
    return sign.to(torch.int32) * (odd << shift.to(torch.int32))


def pack(qt_values: torch.Tensor, scale: torch.Tensor) -> CFMMWeights:
    return CFMMWeights(*decompose(qt_values), scale)


def unpack_int8(w: CFMMWeights) -> torch.Tensor:
    """LUT-decode packed weights back to dense int8 codes."""
    return reconstruct(w.sign, w.mag_idx, w.shift).to(torch.int8)


def product_table(x_q: torch.Tensor) -> torch.Tensor:
    """All unique odd products of each input value: the CFMM block output.

    x_q: int8 activations (...,).  Returns int32 (..., 32) with
    table[..., k] = x * ODD_VALUES[k]: one input value is the common
    factor of all 32 products (paper Fig 3)."""
    odd = torch.from_numpy(ODD_VALUES.astype(np.int32)).to(x_q.device)
    return x_q.to(torch.int32)[..., None] * odd


def cfmm_matmul_exact(x_q: torch.Tensor, w: CFMMWeights) -> torch.Tensor:
    """Product-table CFMM matmul — the FPGA dataflow, exact int32.

    x_q: (M, K) int8; w: packed (K, N).  For every input x[m, k] build the
    32-product table, gather the product mag_idx[k, n] selects, apply the
    free shift and push the sign into the adder tree.  Returns (M, N)
    int32 == x_q @ reconstruct(w).  O(M*K*N) memory: an oracle."""
    table = product_table(x_q)                              # (M, K, 32)
    M, K = x_q.shape
    N = w.mag_idx.shape[1]
    idx = w.mag_idx.long()[None, :, :].expand(M, K, N)      # (M, K, N)
    gathered = torch.gather(table, 2, idx)                  # (M, K, N)
    shifted = gathered << w.shift.to(torch.int32)[None]
    signed = shifted * w.sign.to(torch.int32)[None]
    return signed.sum(dim=1, dtype=torch.int32)             # adder tree


def _dot(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x int8 (K, N) -> int32 (..., N), exact."""
    lead = tuple(x_q.shape[:-1])
    out = int8_matmul_ref(x_q.reshape(-1, x_q.shape[-1]), w)
    return out.reshape(lead + (w.shape[-1],))


def cfmm_matmul_int8(x_q: torch.Tensor, w) -> torch.Tensor:
    """Decode-then-multiply CFMM matmul: LUT decode to int8, then the
    exact int8 product.  ``w`` is packed ``CFMMWeights`` or raw int8
    codes (decode is then the identity)."""
    w_int8 = unpack_int8(w) if isinstance(w, CFMMWeights) else w
    return _dot(x_q, w_int8)


def bitserial_matmul(x_q: torch.Tensor, q_codes: torch.Tensor) -> torch.Tensor:
    """Bit-plane ("bit-serial") matmul: y = sum_b 2^b * (x @ B_b), B_b the
    signed bit-planes of the INT7 codes (|q| <= 63: six planes).  Each
    plane's product is exact (``_dot``); exact int32."""
    sign = torch.sign(q_codes).to(torch.int32)
    mag = torch.abs(q_codes.to(torch.int32))
    acc = torch.zeros(tuple(x_q.shape[:-1]) + (q_codes.shape[-1],),
                      dtype=torch.int32, device=x_q.device)
    for b in range(6):
        plane = (((mag >> b) & 1) * sign).to(torch.int8)
        acc = acc + (_dot(x_q, plane) << b)
    return acc


def unique_product_count(q_codes: torch.Tensor) -> int:
    """Number of unique odd product magnitudes a weight tensor uses
    (paper: <= 32 for INT7)."""
    _, mag_idx, _ = decompose(q_codes)
    nz = q_codes != 0
    return int(torch.unique(mag_idx[nz]).numel()) if bool(nz.any()) else 0


def cfmm_flops_saved(q_codes: torch.Tensor, n_common_uses: int) -> dict:
    """Paper SS II-E.1 accounting: multiplies amortized by the CFMM block.

    A naive implementation multiplies once per (input, nonzero weight)
    pair; CFMM computes <= 32 products per input (one add each) and
    reuses them ``n_common_uses`` times (e.g. 2304 for a 3x3x256 filter
    set, Fig 3)."""
    nnz = int((q_codes != 0).sum())
    total = int(np.prod(tuple(q_codes.shape)))
    return {
        "weights_total": total,
        "weights_nonzero": nnz,
        "sparsity": 1.0 - nnz / max(total, 1),
        "naive_multiplies_per_cf": n_common_uses,
        "cfmm_adds_per_cf": N_UNIQUE_PRODUCTS - 2,  # x1 free, incremental adds
        "amortization": n_common_uses / max(N_UNIQUE_PRODUCTS - 2, 1),
    }
