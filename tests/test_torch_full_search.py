"""K1's plain chain (what the port's full_search_batch runs on CPU
tensors, and what the fused CUDA kernel is held to on the card) against
the reference's full_search_batch (XLA path) and
full_search_batch_pallas (the Pallas SAD grid in interpret mode), on
seeded inputs: blocks on every frame edge, where windows and sources
clamp; non-zero predicted MVs; and a constant plane, where every SAD
ties and the first minimum in (dy, dx) order decides.

Tolerance: exact (MVs and costs are integers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x265_mod_by_patman_tpu.ops import me as jme
from x265_mod_by_patman_tpu_torch.ops import me as tme
from x265_mod_by_patman_tpu_torch.ops.cuda.full_search import (
    full_search_plain)

CPU = torch.device("cpu")


def _edge_blocks(h, w, n):
    """Origins at the four corners, on every edge, half outside the right
    and bottom edges (as a frame whose size is not a multiple of n), and
    one inside."""
    xs = [0, (w - n) // 2, w - n, w - n // 2]
    ys = [0, (h - n) // 2, h - n, h - n // 2]
    return (np.array([x for y in ys for x in xs], np.int32),
            np.array([y for y in ys for x in xs], np.int32))


def _planes(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "constant":
        return np.full((h, w), 117, np.int32), np.full((h, w), 117, np.int32)
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    org = np.roll(ref, (3, -2), (0, 1))
    org[::5] = rng.integers(0, 256, org[::5].shape)
    return ref, org


@pytest.mark.parametrize("kind,n,r,lam,pred", [
    ("random", 8, 4, 700, "random"),
    ("random", 16, 16, 300, "random"),
    ("constant", 8, 4, 300, "odd"),       # ties between neighbours
    ("constant", 16, 16, 0, "random"),    # every cost 0: index 0 wins
])
def test_full_search_matches_reference_and_pallas(kind, n, r, lam, pred):
    h, w = 40, 56
    ref, org = _planes(kind, h, w, n + r)
    x0, y0 = _edge_blocks(h, w, n)
    rng = np.random.default_rng(r)
    if pred == "odd":     # +-2 qpel: two integer MVs cost the same bits
        pmx = np.where(np.arange(x0.size) % 2 == 0, 2, -2).astype(np.int32)
        pmy = -pmx
    else:
        pmx = rng.integers(-70, 70, x0.shape).astype(np.int32)
        pmy = rng.integers(-70, 70, x0.shape).astype(np.int32)
    j = [jnp.asarray(a) for a in (ref, org, x0, y0, pmx, pmy)]
    exp_xla = jme.full_search_batch(*j, lam, n, r, use_pallas=False)
    exp_pl = jme.full_search_batch_pallas(*j, lam, n, r, interpret=True)
    t = [torch.from_numpy(a) for a in (ref, org, x0, y0, pmx, pmy)]
    got = tme.full_search_batch(*t, lam, n, r)
    plain = full_search_plain(*t, lam, n, r)
    for k in range(3):
        e = np.asarray(exp_xla[k])
        np.testing.assert_array_equal(np.asarray(exp_pl[k]), e)
        np.testing.assert_array_equal(got[k].numpy(), e)
        np.testing.assert_array_equal(plain[k].numpy(), e)
        assert got[k].dtype == torch.int32
    if kind == "constant" and lam == 0:
        assert (got[0].numpy() == -4 * r).all()
        assert (got[1].numpy() == -4 * r).all()
