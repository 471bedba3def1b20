"""The host-side launch plan of the kernels that run one thread per g-point
(rrtmgp_tpu_torch.ops._launch.gpoint_plan): pure Python, checked on the CPU.

- up to 1024 g-points one block per column, as the kernels always launched,
  the level sums in the block, no partial buffer; beyond, whole-warp groups
  of at most 1024 threads;
- the groups cover every g-point once;
- a grouped launch's buffers are the level partials, one slot per warp of a
  column, and the cover counts, one per block.

That the kernels write and add the partials in warp order, the bits of the
in-block sums, shows only on a GPU (tests/test_torch_cuda.py at 1100
g-points, chip_smoke.py).
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
