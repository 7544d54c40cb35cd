"""K2's launch plan and the powercap row routine's exits, on the CPU.

``kernel.balance_plan`` is a pure function of the shape and the clusters
the card holds at once, so its choices are checked here at paths A's, B's
and V's shapes and at the reference's 10,000-host ``datacenter_cell``
(``benchmarks/run.py``), with the occupancy answers of an H100 written
out.  The row routine's two exits (``csrc/waterfill.cuh``: stop once the
bisection's bracket has collapsed; run no trip on a degenerate row) are
held bitwise to the routine without them by a NumPy mirror of it: the
same lanes, the same per-lane order and the same butterfly, in fp64.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.powercap import kernel, ref

#: ``cudaOccupancyMaxActiveClusters`` for K2's 1,024-thread blocks on an
#: H100 80GB HBM3 (132 SMs, one block an SM), clusters of 1 to 16 blocks,
#: as the card answered it.
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)
#: The same card if it could not launch clusters above 8 blocks.
PORTABLE_CLUSTERS = H100_CLUSTERS[:8] + (0,) * 8


def test_row_shapes():
    shapes = {1: (4, 1), 4: (4, 1), 5: (8, 1), 10: (16, 1), 16: (16, 1),
              17: (32, 1), 32: (32, 1), 33: (32, 2), 64: (32, 2),
              100: (32, 4), 256: (32, 8), 257: (32, 0), 1000: (32, 0)}
    assert {j: kernel.row_shape(j) for j in shapes} == shapes
    assert [kernel.balance_threads(j) for j in (10, 40, 100, 200, 300)] == \
        [1024, 1024, 512, 512, 1024]
    with pytest.raises(ValueError):
        kernel.row_shape(0)


def test_shared_memory_bound():
    most = kernel.MAX_HOSTS_A_BLOCK
    assert kernel.balance_smem_bytes(most) <= kernel.MAX_SMEM_BYTES
    assert kernel.balance_smem_bytes(most + 1) > kernel.MAX_SMEM_BYTES
    # 32 warps x 4 partials, two slots and a result of 4, then 14 doubles
    # and a flag a host.
    assert kernel.balance_smem_bytes(0) == 8 * (128 + 12)
    assert kernel.balance_smem_bytes(10) - kernel.balance_smem_bytes(9) == 113


@pytest.mark.parametrize("shape, cluster, hosts, threads", [
    ((32, 100, 10), 3, 34, 1024),            # path A: 32 clusters of 3 fit
    ((16, 1000, 10), 6, 167, 1024),          # path B: 15 clusters of 7 do not
    ((1, 1000, 10), 16, 63, 1024),           # path V: the widest cluster
    ((1, 10_000, 10), 16, 625, 1024),        # the datacenter cell
    ((64, 1000, 10), 2, 500, 1024),          # 64 clusters of 3 do not fit
    ((4, 3, 10), 3, 1, 1024),                # never a block without hosts
    ((2, 5000, 100), 16, 313, 512),
])
def test_balance_plan_choices(shape, cluster, hosts, threads):
    s, h, j = shape
    p = kernel.balance_plan(s, h, j, H100_CLUSTERS)
    assert (p.cluster, p.hosts, p.threads) == (cluster, hosts, threads)
    assert p.hosts * p.cluster >= h > p.hosts * (p.cluster - 1)
    assert p.smem_bytes == kernel.balance_smem_bytes(p.hosts)
    assert p.smem_bytes <= kernel.MAX_SMEM_BYTES
    assert 1 <= p.cluster <= kernel.MAX_CLUSTER


def test_balance_plan_takes_the_smallest_cluster_that_holds_the_cell():
    most = kernel.MAX_HOSTS_A_BLOCK
    # Too many cells to widen: the cluster is the smallest that holds them.
    assert kernel.balance_plan(1000, most, 10, H100_CLUSTERS).cluster == 1
    assert kernel.balance_plan(1000, most + 1, 10, H100_CLUSTERS).cluster == 2
    assert kernel.balance_plan(1000, 10_000, 10, H100_CLUSTERS).cluster == 5
    p = kernel.balance_plan(1, 10_000, 10, PORTABLE_CLUSTERS)
    assert (p.cluster, p.hosts) == (8, 1250)


def test_balance_plan_limit():
    most = kernel.MAX_HOSTS_A_BLOCK
    assert kernel.balance_limit(H100_CLUSTERS) == 16 * most >= 10_000
    assert kernel.balance_limit(PORTABLE_CLUSTERS) == 8 * most >= 10_000
    assert kernel.balance_plan(1, 16 * most, 10, H100_CLUSTERS).cluster == 16
    with pytest.raises(ValueError, match=f"limit of {16 * most}"):
        kernel.balance_plan(1, 16 * most + 1, 10, H100_CLUSTERS)
    with pytest.raises(ValueError, match=f"limit of {8 * most}"):
        kernel.balance_plan(1, 8 * most + 1, 10, PORTABLE_CLUSTERS)
    with pytest.raises(ValueError, match="limit of 0"):
        kernel.balance_plan(1, 10, 10, (0,) * 16)


# ------------------------------------------------------ the row routine


def _clip(x, lo, hi):
    return np.fmin(np.fmax(x, lo), hi)


def _lane_sums(terms, g):
    """Each lane's slots in order, then the butterfly over ``g`` lanes:
    ``terms`` is ``(rows, K, G)`` (slot ``sl + G k`` in lane ``sl``)."""
    s = np.zeros(terms.shape[::2])
    for k in range(terms.shape[1]):
        s = s + terms[:, k]
    o = g // 2
    while o:
        s = s + s[:, np.arange(g) ^ o]
        o //= 2
    assert (s == s[:, :1]).all()      # every lane holds the same bits
    return s[:, 0]


def _lane_max(v, g):
    o = g // 2
    while o:
        v = np.fmax(v, v[:, np.arange(g) ^ o])
        o //= 2
    return v[:, 0]


def mirror_rows(cap, floors, ceils, weights, active, iters, exits):
    """``csrc/waterfill.cuh``'s row routine on rows of ``J`` slots, in
    NumPy: returns ``(x, hi, trips)``.  ``exits`` runs it with the collapse
    exit and the degenerate skip, else every row runs all ``iters``."""
    rows, j = floors.shape
    g, k = kernel.row_shape(j)
    k = k or -(-j // 32)                 # streamed: chunks of 32 lanes
    width = g * k
    pad = ((0, 0), (0, width - j))
    f = np.pad(np.where(active, floors, 0.0), pad)
    c = np.pad(np.where(active, ceils, 0.0), pad)
    w = np.pad(np.where(active, weights, 1e-12), pad, constant_values=1e-12)
    c = np.fmax(c, f)
    live = np.arange(width) < j

    def lanes(a):                        # (rows, width) -> (rows, K, G)
        return a.reshape(rows, k, g)

    f3, c3, w3 = lanes(f), lanes(c), lanes(w)
    total_floor = _lane_sums(f3, g)
    degenerate = total_floor >= cap
    target = np.fmin(cap, _lane_sums(c3, g))
    ratio = np.where(live, c / w, -np.inf)
    hi = _lane_max(lanes(ratio).max(axis=1), g) + 1.0
    lo = np.zeros(rows)
    running = ~degenerate if exits else np.ones(rows, dtype=bool)
    trips = np.zeros(rows, dtype=int)
    for _ in range(iters):
        if not running.any():
            break
        mid = 0.5 * (lo + hi)
        under = _lane_sums(_clip(w3 * mid[:, None, None], f3, c3), g) < target
        collapsed = (mid == lo) | (mid == hi)
        lo = np.where(running & under, mid, lo)
        hi = np.where(running & ~under, mid, hi)
        trips += running
        if exits:
            running = running & ~collapsed
    x3 = _clip(w3 * hi[:, None, None], f3, c3)
    gap = target - _lane_sums(x3, g)
    wr3 = np.where((c3 - x3) > 1e-12, w3, 0.0)
    w_room_sum = _lane_sums(wr3, g)
    adjust = (gap > 1e-12) & (w_room_sum > 0.0)
    bump = np.where(adjust[:, None, None],
                    gap[:, None, None] * wr3
                    / np.fmax(w_room_sum, 1e-300)[:, None, None], 0.0)
    out = _clip(x3 + bump, f3, c3)
    scale = cap / np.fmax(total_floor, 1e-12)
    out = np.where(degenerate[:, None, None], f3 * scale[:, None, None], out)
    return out.reshape(rows, width)[:, :j], hi, trips


def seeded_rows(j: int, seed: int):
    """Random rows plus rows whose level goes to its top (capacity above
    the ceilings), to 0 (a capacity of 1e-300 over zero floors: the bracket
    halves on every trip) and degenerate ones (floors above capacity)."""
    rng = np.random.default_rng(seed)
    n = 24
    floors = np.where(rng.random((n, j)) < 0.3,
                      rng.uniform(0.0, 300.0, (n, j)), 0.0)
    floors[3:6] = 0.0
    floors[6:9] = rng.uniform(10.0, 300.0, (3, j))
    ceils = floors + rng.uniform(0.0, 3000.0, (n, j))
    weights = rng.choice([1000.0, 2000.0], (n, j)) * rng.uniform(
        0.5, 2.0, (n, 1))
    active = rng.random((n, j)) < 0.85
    active[:, 0] = True
    cap = rng.uniform(0.2, 1.2, n) * (ceils * active).sum(-1)
    cap[0:3] = (ceils * active).sum(-1)[0:3] * np.array([1.0, 1.5, 1e3])
    cap[3:6] = (1e-300, 1e-9, 0.0)
    cap[6:9] = (floors * active).sum(-1)[6:9] * np.array([0.999, 0.5, 0.0])
    return cap, floors, ceils, weights, active


#: Rows of :func:`seeded_rows` whose floors reach their capacity.
DEGENERATE = slice(5, 9)


@pytest.mark.parametrize("j", (3, 10, 40, 100, 300))
@pytest.mark.parametrize("iters", (100, 200))
def test_exits_leave_the_row_routine_bitwise_unchanged(j, iters):
    cap, fl, ce, w, act = seeded_rows(j, seed=j * 31 + iters)
    full, full_hi, full_trips = mirror_rows(cap, fl, ce, w, act, iters,
                                            exits=False)
    short, short_hi, trips = mirror_rows(cap, fl, ce, w, act, iters,
                                         exits=True)
    degenerate = np.zeros(cap.size, dtype=bool)
    degenerate[DEGENERATE] = True
    np.testing.assert_array_equal(short, full)
    # A degenerate row's level is never read; every other row's is the
    # same bits.
    np.testing.assert_array_equal(short_hi[~degenerate], full_hi[~degenerate])
    assert (full_trips == iters).all()
    assert (trips[degenerate] == 0).all()
    # The level that goes to 0 halves the bracket on every trip; the
    # random rows and those whose level goes to the top stop early.
    assert trips[3] == iters
    quick = ~degenerate
    quick[3:5] = False
    assert trips[quick].max() < 70 <= iters
    # And the mirror is the plain version's arithmetic.
    t = [torch.from_numpy(a) for a in (cap, fl, ce, w)]
    want = ref.waterfill_dense_ref(*t, iters, torch.from_numpy(act))
    np.testing.assert_allclose(full, want.numpy(), rtol=1e-9, atol=1e-9)
