"""Device-independent numeric helpers.

The encoder's decisions must come out the same on the CPU and on the
card, so three things are pinned down here instead of left to each
backend:

* integer matrix products (CUDA has no int32 GEMM): computed in float64,
  which is exact while every partial sum stays below 2**53;
* float32 sums: where the reference's CPU backend is known to add the
  terms left to right in row-major order, that order (osum; on the card
  the hand kernel K3, ops.cuda.ordered_sum), where it vectorises a
  fused n x n sum, its lane order (lsum, csum; K3's lane modes);
  elsewhere a fixed pairwise order (fsum, halving the reduced axis), so
  the rounding does not depend on the backend's reduction tree;
* float32 transcendental functions: evaluated in float64 and rounded
  once to float32, except where a decision rides the reference's own
  float32 value: 2**q for the integer exponents of the RDOQ level scale
  (exp2_ref), and the log, log2 and lambda of the wavefront, the inter
  TU32 pre-pass and RDOQ (log_ref, log2_ref, floor_log2_ref, lam2_ref,
  lam2_exp_ref), tables of what the reference's CPU backend computes,
  built here from its polynomials.
"""
from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch


_EINSUM_LOCK = threading.Lock()


def ieinsum(eq: str, *ops) -> torch.Tensor:
    """Exact int32 einsum (JAX's preferred_element_type=int32).  Any
    contraction order is exact here, so opt_einsum's path search (a
    host cost on every call, larger than the small products it orders)
    is skipped: the operands contract left to right.  The switch is
    process-wide, so encoders running in threads take it in turn."""
    with _EINSUM_LOCK, torch.backends.opt_einsum.flags(enabled=False):
        r = torch.einsum(eq, *[o.to(torch.float64) for o in ops])
    return torch.round(r).to(torch.int64).to(torch.int32)


def fsum(x: torch.Tensor, dims) -> torch.Tensor:
    """float32 sum over `dims` in a fixed pairwise order."""
    if isinstance(dims, int):
        dims = (dims,)
    nd = x.dim()
    dims = sorted(d % nd for d in dims)
    keep = [d for d in range(nd) if d not in dims]
    x = x.permute(*keep, *dims)
    x = x.reshape(*x.shape[:len(keep)], -1)
    n = x.shape[-1]
    p = 1
    while p < n:
        p <<= 1
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def osum_plain(xt: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: (K, M) float32 terms -> (M,) sums, the terms
    of each column added in order of k from a float32 zero."""
    acc = torch.zeros(xt.shape[1:], dtype=torch.float32, device=xt.device)
    for k in range(xt.shape[0]):
        acc = acc + xt[k]
    return acc


def lanes_sum_plain(xt: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of K3's lane mode: (n*n, M) float32 terms, each
    column an n x n block in row-major order -> (M,) sums in the order
    the reference's CPU backend gives a fused TU sum (8-lane vectors):
    for n <= 8 each row summed left to right, then the n row sums as a
    tree (j + n/2 into j, halving); for n >= 16 row by row, lane j
    summing the row's terms j, j + 8, ... after the running sum is
    added into lane 0's first term, the 8 lanes as a tree (j + 4, + 2,
    + 1) giving the new running sum."""
    x = xt.reshape(n, n, -1)
    if n <= 8:
        lanes = [osum_plain(x[r]) for r in range(n)]
        w = n // 2
        while w >= 1:
            lanes = [lanes[j] + lanes[j + w] for j in range(w)]
            w //= 2
        return lanes[0]
    return chain_sum_plain(xt, n, 8, n)


def chain_sum_plain(xt: torch.Tensor, n: int, lanes: int,
                    span: int) -> torch.Tensor:
    """Plain version of K3's chained lane mode: (n*n, M) float32 terms,
    each column an n x n block in row-major order -> (M,) sums, row by
    row: `lanes` lanes, lane j adding the row's terms j, j + lanes, ...
    below column `span` after the running sum is added into lane 0's
    first term; the lanes add as a halving tree (j with j + lanes/2, and
    so on), and the row's terms from column `span` on are then added one
    by one, giving the new running sum.  The order of a fused n x n sum
    that the reference's CPU backend vectorises `lanes` wide: (8, n) for
    its TU costs at n >= 16 (lanes_sum_plain), and per lane count the
    wavefront's TB bit estimates (ops.rdoq.tb_bits_est)."""
    x = xt.reshape(n, n, -1)
    acc = torch.zeros(x.shape[2:], dtype=torch.float32, device=xt.device)
    for r in range(n):
        lane = x[r, :lanes].clone()
        lane[0] = acc + lane[0]
        for c in range(lanes, span, lanes):
            lane = x[r, c:c + lanes] + lane
        h = lanes // 2
        while h >= 1:
            lane = lane[:h] + lane[h:2 * h]
            h //= 2
        acc = lane[0]
        for c in range(span, n):
            acc = acc + x[r, c]
    return acc


def lsum(x: torch.Tensor) -> torch.Tensor:
    """(..., n, n) float32 -> (...) sums of each n x n block in the
    reference's fused TU-sum order (lanes_sum_plain; K3's lane mode on
    the card, reading the blocks where x holds them)."""
    from .cuda.ordered_sum import ordered_sum_lanes
    n = x.shape[-1]
    lead = x.shape[:-2]
    # a view wherever the leading dims merge (always for the callers'
    # contiguous terms); otherwise reshape makes the one copy
    blocks = x.to(torch.float32).reshape(math.prod(lead), n, n)
    return ordered_sum_lanes(blocks, n).reshape(lead)


def csum(x: torch.Tensor, lanes: int, span: int) -> torch.Tensor:
    """(..., n, n) float32 -> (...) sums of each n x n block in the
    chained lane order chain_sum_plain(., n, lanes, span) (K3's chained
    lane mode on the card, reading the blocks where x holds them)."""
    from .cuda.ordered_sum import ordered_sum_chained
    n = x.shape[-1]
    lead = x.shape[:-2]
    blocks = x.to(torch.float32).reshape(math.prod(lead), n, n)
    return ordered_sum_chained(blocks, n, lanes, span).reshape(lead)


def osum(x: torch.Tensor, dims) -> torch.Tensor:
    """float32 sum over `dims`, the terms added one by one in row-major
    order of the reduced dims (K3 on the card, osum_plain on the CPU),
    read where x holds them."""
    from .cuda.ordered_sum import ordered_sum
    return ordered_sum(x.to(torch.float32), dims)


def fma32(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as the reference's CPU backend
    contracts a multiply into the add that consumes it (float64 holds
    the product of two float32 exactly).  b may be a Python number."""
    f = lambda x: x.to(torch.float64) if isinstance(x, torch.Tensor) else x
    return (f(a) * f(b) + f(c)).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _exp2_ref_table(device) -> torch.Tensor:
    arg = (np.arange(64, dtype=np.float64)
           * np.float64(np.float32(np.log(2.0)))).astype(np.float32)
    return torch.from_numpy(
        np.exp(arg.astype(np.float64)).astype(np.float32)).to(device)


def exp2_ref(q: torch.Tensor) -> torch.Tensor:
    """float32 2**q for integer q in [0, 63] as the reference's backend
    (XLA on the CPU) evaluates float32 exp2: exp(q * ln2) with the product
    rounded to float32, so odd q come out inexact (524287.78 for q = 19).
    The RDOQ level scale divides by it: an exact .5 tie of the scaled
    coefficient then falls on the reference's side."""
    return _exp2_ref_table(q.device)[q.long()]


def fsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


# -- the reference's float32 log, log2 and lambda ----------------------------
# XLA's CPU backend evaluates float32 log and exp inline, as Cephes-style
# polynomials.  Their constants, and where a multiply is contracted into
# the add that consumes it (one rounding), are read from the reference's
# compiled wavefront: jit(_wavefront_tree_body) and jit(_wavefront_body)
# on the CPU, their fusions' LLVM IR (*.ir-with-opt.ll) and object code
# (the vfmadd / vmul instructions; XLA_FLAGS=--xla_dump_to=DIR writes
# both).  The tables below are built from them in float32, each
# contracted multiply-add rounded once, so they hold the reference's
# values on the card and the CPU alike.

def _f32(bits: int) -> np.float32:
    return np.array([bits], np.uint32).view(np.float32)[0]


# log: x = m * 2**e with m in [sqrt(1/2), sqrt(2)); t = m - 1;
# log x = t - t*t/2 + t**3 * P(t) + e * (Q2 + Q1), P of degree 8 as three
# interleaved Horner chains
_LOG_P = tuple(_f32(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
    0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))
_LOG_Q1, _LOG_Q2 = _f32(0xB95E8083), _f32(0x3F318000)
_SQRT_HALF = _f32(0x3F3504F3)
_MIN_NORMAL = _f32(0x00800000)
LOG2E_F32 = _f32(0x3FB8AA3B)        # float32(1 / ln 2): log2 x = log x * it
# exp: n = floor(x * log2(e) + 1/2), r = x - n * ln 2 (in two parts),
# exp x = 2**n * (1 + r + r*r * E(r)), E of degree 5
_EXP_E = tuple(_f32(b) for b in (0x39506967, 0x3AB743CE, 0x3C088908,
                                 0x3D2AA9C1, 0x3E2AAAAA))
_EXP_LO, _EXP_HI = _f32(0xC2AF999A), _f32(0x42B1999A)
# the lambda's exponent (qp - 12) / 3 * ln 2 as the reference folds it:
# (qp - 12) times float32(ln 2 / 3)
_LN2_3 = _f32(0x3E6C9820)
LOG_REF_MAX = 32769                 # |level| + 1, |level| <= 32768
LAM2_REF_QPS = (-128, 127)          # the QPs lam2_ref takes


def _fma_f32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, on numpy arrays (the contracted
    multiply-add of the reference's object code).  float64 holds the
    product exactly; its sum with c is rounded to odd (the float64
    neighbour with an odd last bit wherever the sum is inexact), so
    rounding that on to float32 rounds the exact value once."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)          # the exact p + c - s
    odd = (s.view(np.int64) & 1) == 1
    toward = np.where(err > 0, np.inf, -np.inf)
    s = np.where((err != 0) & ~odd, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def _xla_log(x: np.ndarray, fma=_fma_f32) -> np.ndarray:
    """float32 natural log of x > 0 (numpy) as the reference's CPU
    backend computes it; fma: the contracted multiply-add."""
    f32 = np.float32
    x = np.maximum(np.asarray(x, f32), _MIN_NORMAL)
    bits = x.view(np.int32)
    e = ((bits >> 23) - 127).astype(f32) + f32(1)
    m = ((bits & np.int32(-2139095041)) | np.int32(0x3F000000)).view(f32)
    low = m < _SQRT_HALF
    t = (m - f32(1)) + np.where(low, m, f32(0))
    e = e - np.where(low, f32(1), f32(0))
    t2 = t * t
    t3 = t2 * t
    p = _LOG_P
    y1 = fma(fma(t, p[0], p[1]), t, p[2])
    y2 = fma(fma(t, p[3], p[4]), t, p[5])
    y3 = fma(fma(t, p[6], p[7]), t, p[8])
    y = fma(fma(y1, t3, y2), t3, y3)
    y = fma(y, t3, e * _LOG_Q1)
    r = fma(f32(-0.5), t2, t) + y
    return fma(e, _LOG_Q2, r)


def _xla_exp(x: np.ndarray, fma=_fma_f32) -> np.ndarray:
    """float32 e**x (numpy) as the reference's CPU backend computes it."""
    f32 = np.float32
    x = np.minimum(np.maximum(np.asarray(x, f32), _EXP_LO), _EXP_HI)
    n = np.clip(np.floor(fma(x, LOG2E_F32, f32(0.5))), f32(-127), f32(127))
    r = fma(n, -_LOG_Q2, x)
    r = fma(n, -_LOG_Q1, r)
    p = fma(r, _EXP_E[0], _EXP_E[1])
    for c in _EXP_E[2:] + (f32(0.5),):
        p = fma(p, r, c)
    p = f32(1) + fma(p, r * r, r)
    return p * np.ldexp(f32(1), n.astype(np.int32)).astype(f32)


@functools.lru_cache(maxsize=None)
def _log_tables(device) -> tuple:
    """(log, log2) of the integers 1..LOG_REF_MAX."""
    ln = _xla_log(np.arange(1, LOG_REF_MAX + 1, dtype=np.float32))
    l2 = ln * LOG2E_F32
    return (torch.from_numpy(ln).to(device), torch.from_numpy(l2).to(device))


def _lookup(table: torch.Tensor, i: torch.Tensor, lo: int, hi: int,
            what: str) -> torch.Tensor:
    """table[i - lo] for integers lo <= i <= hi; raises outside (on the
    CPU at once, on the card through the index kernel's bounds check)."""
    i = i.long()
    if i.device.type == "cpu" and i.numel() and \
            (int(i.min()) < lo or int(i.max()) > hi):
        raise ValueError(f"{what} takes integers in [{lo}, {hi}], got "
                         f"[{int(i.min())}, {int(i.max())}]")
    # index_select refuses a negative index (advanced indexing would wrap)
    return table.index_select(0, (i - lo).reshape(-1)).reshape(i.shape)


def log_ref(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of the integer-valued x in [1, LOG_REF_MAX] as
    the reference's wavefront computes it (the candidate rate's
    3 + 2 * log2(|level| + 1), which its program evaluates as one
    multiply-add log(.) * float32(2 / ln 2) + 3)."""
    return _lookup(_log_tables(x.device)[0], x, 1, LOG_REF_MAX, "log_ref")


def log2_ref(x: torch.Tensor) -> torch.Tensor:
    """float32 log2 of the integer-valued x in [1, LOG_REF_MAX] as the
    reference's CPU backend computes jnp.log2: log_ref(x) * float32(1 /
    ln 2), rounded.  Its floor is one less than the exact one at 8192
    and 32768 (12.999999 and 14.999999)."""
    return _lookup(_log_tables(x.device)[1], x, 1, LOG_REF_MAX, "log2_ref")


@functools.lru_cache(maxsize=None)
def _lam2_tables(device) -> tuple:
    """(exp, lambda) tables over LAM2_REF_QPS: e = XLA's exp of (qp - 12)
    * float32(ln 2 / 3), and e * 0.85 rounded."""
    q = np.arange(LAM2_REF_QPS[0], LAM2_REF_QPS[1] + 1).astype(
        np.float32)
    e = _xla_exp((q + np.float32(-12.0)) * _LN2_3)
    return (torch.from_numpy(e).to(device),
            torch.from_numpy(e * np.float32(0.85)).to(device))


def lam2_ref(qp: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """The SSE lambda 0.85 * 2**((qp - 12) / 3) * 4**(bd - 8) as the
    reference's wavefront and inter TU32 pre-pass compute it in float32:
    exp((qp - 12) * float32(ln 2 / 3)) by its exp, times 0.85, rounded
    (the factor 4**(bd - 8) is exact)."""
    return _lookup(_lam2_tables(qp.device)[1], qp, *LAM2_REF_QPS,
                   "lam2_ref") * float(1 << (2 * (bit_depth - 8)))


def lam2_exp_ref(qp: torch.Tensor) -> torch.Tensor:
    """The float32 2**((qp - 12) / 3) that lam2_ref multiplies by 0.85:
    where the reference scales the lambda again (lam2 * 3.0 in the TU32
    choice), its compiler folds 0.85 into that constant and multiplies
    this value once."""
    return _lookup(_lam2_tables(qp.device)[0], qp, *LAM2_REF_QPS,
                   "lam2_exp_ref")


# floor(log2 x) of the reference's float32 log2 (log_ref * LOG2E_F32) at
# the integers 1 <= x < 2**24 departs from the exact floor on these
# intervals [lo, hi] (one short at the powers of two 8192 and 32768, one
# over just below 2**21, ..., 2**24), read by evaluating _xla_log at every
# such integer: _FLOOR_LOG2_BOUNDS are the interval ends (lo, hi + 1),
# _FLOOR_LOG2_STEP the correction between consecutive ends
_FLOOR_LOG2_DEPARTS = ((8192, 8192, -1), (32768, 32768, -1),
                       (2097151, 2097151, 1), (4194303, 4194303, 1),
                       (8388601, 8388607, 1), (16777201, 16777215, 1))
_FLOOR_LOG2_MAX = 1 << 24


@functools.lru_cache(maxsize=None)
def _floor_log2_tables(device) -> tuple:
    ends, step = [], [0.0]
    for lo, hi, c in _FLOOR_LOG2_DEPARTS:
        ends += [lo, hi + 1]
        step += [float(c), 0.0]
    return (torch.tensor(ends, dtype=torch.float32, device=device),
            torch.tensor(step, dtype=torch.float32, device=device))


def floor_log2_ref(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 x) of the integer-valued float32 x in [1, 2**24) as the
    reference computes it, floor(log_ref(x) * LOG2E_F32) (log2_ref's
    floor where that table reaches): the exact floor, one less at 8192
    and 32768 and one more on the few runs just below 2**21 to 2**24
    (_FLOOR_LOG2_DEPARTS)."""
    ends, step = _floor_log2_tables(x.device)
    exact = (torch.frexp(x)[1] - 1).to(torch.float32)
    return exact + step[torch.searchsorted(ends, x.contiguous(), right=True)]
