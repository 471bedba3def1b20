"""The host-side launch plan of the kernels that run one thread per g-point
(rrtmgp_tpu_torch.ops._launch.gpoint_plan): pure Python, checked on the CPU.

- up to 1024 g-points one block per column, as the kernels always launched,
  the level sums in the block, no partial buffer; beyond, whole-warp groups
  of at most 1024 threads;
- the groups cover every g-point once;
- a grouped launch's buffers are the level partials, one slot per warp of a
  column, and the cover counts, one per block;
- a kernel whose registers allow fewer threads a block than 1024
  (``max_threads``, cudaFuncAttributes.maxThreadsPerBlock on the card)
  gets groups of at most that many threads: 1000 g-points at a limit of 800
  are two blocks of 512, never one block the card refuses to launch.

That the kernels write and add the partials in warp order, the bits of the
in-block sums, shows only on a GPU (tests/test_torch_cuda.py at 1100
g-points, chip_smoke.py).

The plans of the per-g-point sweeps' shared memory (``rte_kernels.
sw_2stream_gpt_design``, ``lw_noscat_gpt_design``): the bottom levels or
layers they keep within [0, nlay], a column that fits whole, the block's
bytes within the device's limit.

And the plan of the band Planck kernel over the temperature sets of one
launch (``sets_plan``): every point of every set covered once, by blocks of
``span`` consecutive points; sets of 0 points own no block; more than three
sets, sizes past 32-bit ints and an empty span are refused.
"""

import pytest
import torch

from rrtmgp_tpu_torch.ops import _launch as L
from rrtmgp_tpu_torch.ops import rte_kernels

NGPTS = (1, 5, 31, 32, 33, 36, 224, 256, 1000, 1024, 1025, 1100, 2048, 2049, 4096)


@pytest.mark.parametrize("ngpt", NGPTS)
def test_groups_cover_every_gpoint_once(ngpt):
    plan = L.gpoint_plan(ngpt)
    assert plan.group % 32 == 0 and 32 <= plan.group <= L.MAX_THREADS
    covered = [b * plan.group + t for b in range(plan.n_groups) for t in range(plan.group)
               if b * plan.group + t < ngpt]
    assert covered == list(range(ngpt))
    assert (plan.n_groups - 1) * plan.group < ngpt  # no block without a g-point


@pytest.mark.parametrize("ngpt", NGPTS)
def test_up_to_1024_gpoints_launch_one_block_per_column(ngpt):
    plan = L.gpoint_plan(ngpt)
    if ngpt <= 1024:
        assert plan == L.LaunchPlan(-(-ngpt // 32) * 32, 1) and not plan.grouped
        assert L.level_partials(plan, 2, 61, 8, torch.float32, torch.device("cpu")) is None
        assert L.cover_counts(plan, 8, True, torch.device("cpu")) is None
    else:
        assert plan.grouped and plan.n_groups == -(-ngpt // 1024)


@pytest.mark.parametrize("ngpt", [1025, 1100, 2049, 4096])
def test_grouped_launch_buffers(ngpt):
    plan = L.gpoint_plan(ngpt)
    nf, nlev, ncol = 3, 61, 5
    part = L.level_partials(plan, nf, nlev, ncol, torch.float32, torch.device("cpu"))
    assert part.shape == (nf, nlev, ncol, plan.n_groups * plan.group // 32)
    counts = L.cover_counts(plan, ncol, True, torch.device("cpu"))
    assert counts.shape == (ncol, plan.n_groups) and counts.dtype == torch.int32
    assert L.cover_counts(plan, ncol, False, torch.device("cpu")) is None


def test_no_gpoint_count_is_refused_but_zero():
    assert rte_kernels._dims(torch.empty(2, 3, 1100), "lw_noscat_reduced") == (2, 3, 1100)
    with pytest.raises(ValueError, match="n_gpt=0"):
        L.gpoint_plan(0)


# The plan with the depth, the element size and the device's limit: an
# H100's opt-in limit per block, passed in as the wrappers read it there.
H100_OPTIN = 232448


def _max_in_block_nlay(ngpt, fields, itemsize, staged, limit):
    warps = -(-ngpt // 32)
    return (limit - staged) // (fields * warps * itemsize) - 1


@pytest.mark.parametrize("ngpt,fields,itemsize", [(224, 3, 4), (256, 2, 4), (256, 2, 8), (1024, 3, 4), (36, 2, 4)])
def test_in_block_up_to_the_limit_then_one_block_with_device_sums(ngpt, fields, itemsize):
    deepest = _max_in_block_nlay(ngpt, fields, itemsize, 128, H100_OPTIN)
    fits = L.gpoint_plan(ngpt, deepest, fields, itemsize, 128, H100_OPTIN)
    assert fits == L.gpoint_plan(ngpt) and fits.in_block
    assert 128 + L.in_block_bytes(fits.group, deepest, fields, itemsize) <= H100_OPTIN
    past = L.gpoint_plan(ngpt, deepest + 1, fields, itemsize, 128, H100_OPTIN)
    assert past == L.LaunchPlan(fits.group, 1, False) and not past.grouped
    part = L.level_partials(past, fields, deepest + 2, 4, torch.float32, torch.device("cpu"))
    assert part.shape == (fields, deepest + 2, 4, fits.group // 32)
    assert L.cover_counts(past, 4, True, torch.device("cpu")).shape == (4, 1)


@pytest.mark.parametrize("ngpt,nlay,fields", [(224, 2800, 3), (256, 3700, 2), (1024, 610, 3)])
def test_the_depths_that_failed_at_launch_take_device_sums(ngpt, nlay, fields):
    plan = L.gpoint_plan(ngpt, nlay, fields, 4, 128, H100_OPTIN)
    assert plan.n_groups == 1 and not plan.in_block


def test_staged_bytes_count_against_the_limit():
    deepest = _max_in_block_nlay(256, 2, 4, 0, H100_OPTIN)
    assert L.gpoint_plan(256, deepest, 2, 4, 0, H100_OPTIN).in_block
    assert not L.gpoint_plan(256, deepest, 2, 4, 4096, H100_OPTIN).in_block
    staged_deepest = _max_in_block_nlay(256, 2, 4, 4096, H100_OPTIN)
    assert L.gpoint_plan(256, staged_deepest, 2, 4, 4096, H100_OPTIN).in_block
    with pytest.raises(ValueError, match="staged"):
        L.gpoint_plan(256, 60, 2, 4, H100_OPTIN + 1, H100_OPTIN)
    with pytest.raises(ValueError, match="limit"):
        L.gpoint_plan(256, 60, 2, 4, 0, None)


@pytest.mark.parametrize("ngpt", [1, 36, 224, 256, 1024, 1025, 4096, 16384])
@pytest.mark.parametrize("nlay", [1, 60, 800, 2760, 3631, 3632, 100000])
def test_every_depth_and_gpoint_count_gets_a_plan(ngpt, nlay):
    for fields, itemsize in ((2, 4), (3, 4), (2, 8)):
        plan = L.gpoint_plan(ngpt, nlay, fields, itemsize, 128, H100_OPTIN)
        assert plan.n_groups * plan.group >= ngpt and plan.group <= L.MAX_THREADS
        assert plan.in_block == (plan.n_groups == 1 and 128 + L.in_block_bytes(plan.group, nlay, fields, itemsize)
                                 <= H100_OPTIN)
        assert plan.in_block or (L.level_partials(plan, fields, nlay + 1, 1, torch.float32, torch.device("meta"))
                                 .shape == (fields, nlay + 1, 1, plan.n_groups * plan.group // 32))


# The plan with the kernel's block limit (``max_threads``): on the card the
# wrappers read cudaFuncAttributes.maxThreadsPerBlock of the instance they
# launch, the smaller of its in-block and split variants.
LIMITS = (1024, 896, 800, 512, 64)


def test_1000_gpoints_at_a_limit_of_800_are_two_blocks_of_512():
    assert L.gpoint_plan(1000, max_threads=800) == L.LaunchPlan(512, 2, False)
    assert L.gpoint_plan(1000, 60, 2, 4, 128, H100_OPTIN, 800) == L.LaunchPlan(512, 2, False)
    assert L.gpoint_plan(1000, max_threads=1024) == L.gpoint_plan(1000) == L.LaunchPlan(1024, 1, True)


@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("ngpt", NGPTS)
def test_groups_of_a_limit_cover_every_gpoint_once(ngpt, limit):
    plan = L.gpoint_plan(ngpt, max_threads=limit)
    assert plan.group % 32 == 0 and 32 <= plan.group <= limit
    assert plan.n_groups == -(-ngpt // limit)
    covered = [b * plan.group + t for b in range(plan.n_groups) for t in range(plan.group)
               if b * plan.group + t < ngpt]
    assert covered == list(range(ngpt))
    assert (plan.n_groups - 1) * plan.group < ngpt


@pytest.mark.parametrize("limit", LIMITS)
@pytest.mark.parametrize("ngpt", NGPTS)
def test_a_column_over_several_blocks_never_sums_in_the_block(ngpt, limit):
    for nlay in (1, 60, 800):
        plan = L.gpoint_plan(ngpt, nlay, 2, 4, 128, H100_OPTIN, limit)
        assert plan.group <= limit
        if plan.n_groups > 1:
            assert not plan.in_block
        part = L.level_partials(plan, 2, nlay + 1, 3, torch.float32, torch.device("meta"))
        assert (part is None) == plan.in_block


@pytest.mark.parametrize("ngpt", (224, 256))
def test_the_main_paths_plan_as_before_under_every_limit_above_them(ngpt):
    for limit in (1024, 896, 800, 512, 256):
        assert L.gpoint_plan(ngpt, 60, 3, 4, 128, H100_OPTIN, limit) == L.gpoint_plan(ngpt, 60, 3, 4, 128, H100_OPTIN)


def test_a_limit_below_one_warp_is_refused():
    assert L.gpoint_plan(100, max_threads=63) == L.gpoint_plan(100, max_threads=32)
    with pytest.raises(ValueError, match="no warp"):
        L.gpoint_plan(100, max_threads=31)


def test_kernel_plan_asks_the_kernels_limit_and_records_it(monkeypatch):
    """The wrappers plan through ``kernel_plan``: the block limit of the
    kernel's instance and the device's shared-memory limit, and the plan is
    recorded with the limit (what chip_smoke.py prints)."""
    asked = []
    monkeypatch.setattr(L, "max_threads", lambda kernel, dev, variant=0: asked.append((kernel, variant)) or 800)
    monkeypatch.setattr(L, "smem_limit", lambda dev: H100_OPTIN)
    plan = L.kernel_plan("lw2_mega", torch.device("cpu"), 1000, 60, 2, 4, 128, variant=6)
    assert plan == L.LaunchPlan(512, 2, False) and asked == [("lw2_mega", 6)]
    assert L.LAST_PLANS["lw2_mega"] == (plan, 800)
    assert L.kernel_plan("lw2_mega", torch.device("cpu"), 256, 60, 2, 4, 128) == L.LaunchPlan(256, 1, True)


def test_per_thread_bytes_count_against_the_limit():
    """A kernel that keeps ``per_thread`` bytes of shared memory for each
    thread (lw_2stream_reduced's chunk state) counts them for its group:
    its level sums leave the block one layer earlier than without, and a
    block whose own bytes pass the limit is refused."""
    per = 128
    deepest = _max_in_block_nlay(256, 2, 4, per * 256, H100_OPTIN)
    assert L.gpoint_plan(256, deepest, 2, 4, 0, H100_OPTIN, per_thread=per).in_block
    assert not L.gpoint_plan(256, deepest + 1, 2, 4, 0, H100_OPTIN, per_thread=per).in_block
    assert L.gpoint_plan(256, deepest + 1, 2, 4, 0, H100_OPTIN).in_block
    big = L.gpoint_plan(1000, 60, 2, 4, 0, H100_OPTIN, per_thread=per)
    assert big == L.LaunchPlan(1024, 1, True) and per * 1024 + L.in_block_bytes(1024, 60, 2, 4) <= H100_OPTIN
    with pytest.raises(ValueError, match="staged"):
        L.gpoint_plan(256, 60, 2, 4, 0, H100_OPTIN, per_thread=H100_OPTIN // 200)


GPT_CASES = [(60, 256, 1024, None), (8, 256, 1024, None), (16, 256, 1024, None), (3, 5, 1024, None),
             (60, 1100, 1024, None), (800, 1000, 800, None), (60, 256, 1024, 8 * 256 * 5),
             (60, 1024, 1024, 8 * 1024 - 1), (60, 224, 640, 0)]


@pytest.mark.parametrize("kernel,most", [("lw_noscat_gpt", "LW_GPT_LAYERS"), ("sw_2stream_gpt", "SW_GPT_LEVELS")])
@pytest.mark.parametrize("nlay,ngpt,limit_threads,limit", GPT_CASES)
def test_per_gpoint_sweep_plans_keep_what_fits(monkeypatch, kernel, most, nlay, ngpt, limit_threads, limit):
    """The per-g-point sweeps keep C of a column's bottom levels or layers
    of state in shared memory: C in [0, nlay], at most their constant, a
    column of fewer layers whole, and fewer where the kernel's block would
    not hold them (the block's bytes within the device's limit, down to
    none when one does not fit); the launch plan is the kernel's own (1100
    g-points: two blocks of 576)."""
    limit = H100_OPTIN if limit is None else limit
    monkeypatch.setattr(L, "max_threads", lambda kernel, dev, variant=0: limit_threads)
    monkeypatch.setattr(L, "smem_limit", lambda dev: limit)
    monkeypatch.setattr(rte_kernels, most, 16)
    design = getattr(rte_kernels, f"{kernel}_design")(nlay, ngpt, torch.device("cpu"))
    c, plan = design["kept"], L.gpoint_plan(ngpt, max_threads=limit_threads)
    per = rte_kernels.BOTTOM_STATE_BYTES
    assert (design["group"], design["n_groups"]) == (plan.group, plan.n_groups)
    assert 0 <= c <= min(nlay, 16)
    assert design["smem"] == per * c * plan.group <= limit
    assert c == min(nlay, 16) or per * (c + 1) * plan.group > limit
    if nlay <= 16 and limit == H100_OPTIN:
        assert c == nlay  # held whole
    assert design["max_threads"] == limit_threads and L.LAST_PLANS[kernel][0].group == plan.group


SET_SIZES = [(1,), (255,), (256,), (257,), (2**20 + 3,), (0,), (255, 256, 257), (0, 257), (257, 0, 1),
             (2**20 + 3, 0, 31), (0, 0, 0)]


@pytest.mark.parametrize("sizes", SET_SIZES)
@pytest.mark.parametrize("span", [256, L.PLANCK_SPAN, 4096])
def test_sets_plan_covers_every_point_of_every_set_once(sizes, span):
    plan = L.sets_plan(sizes, span)
    assert len(plan.starts) == L.PLANCK_SETS + 1 and plan.starts[0] == 0
    assert list(plan.starts) == sorted(plan.starts)
    seen = [[] for _ in sizes]
    for block in range(plan.grid):
        k, points = L.block_points(plan, sizes, block)
        assert len(points) > 0  # no block without a point
        seen[k].append(points)
    for k, n in enumerate(sizes):
        covered = [i for r in seen[k] for i in r]
        assert covered == list(range(n)), (k, n)
        assert plan.starts[k + 1] - plan.starts[k] == -(-n // span)
    assert all(s == plan.grid for s in plan.starts[len(sizes):])


def test_sets_plan_refuses_what_one_launch_does_not_take():
    for sizes in ((), (1, 2, 3, 4)):
        with pytest.raises(ValueError, match="sets"):
            L.sets_plan(sizes)
    for n in (-1, 2**31):
        with pytest.raises(ValueError, match="points"):
            L.sets_plan((5, n))
    assert L.sets_plan((2**31 - 1,)).grid == -(-(2**31 - 1) // L.PLANCK_SPAN)
    with pytest.raises(ValueError, match="span"):
        L.sets_plan((5,), 0)
