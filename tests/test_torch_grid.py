"""The port's virtual-rank grid math (mlsl_tpu_torch.comm.mesh) against the JAX
package's Topology/ProcessGroup and ``collectives._axis_groups_tbl``, over a
sweep of grids. Integer math: every comparison is exact."""

import itertools

import jax
import pytest
import torch

from mlsl_tpu.comm import collectives as jcoll
from mlsl_tpu.comm.mesh import GRID_AXES, ProcessGroup as JGroup, Topology as JTopo
from mlsl_tpu_torch.comm import collectives as tcoll
from mlsl_tpu_torch.comm.mesh import ProcessGroup as TGroup, Topology as TTopo
from mlsl_tpu_torch.log import MLSLError

torch.set_num_threads(2)

# (world, data, model, seq)
GRIDS = [
    (8, 8, 1, 1), (8, 1, 8, 1), (8, 4, 2, 1), (8, 2, 4, 1), (8, 2, 2, 1),
    (8, 2, 2, 2), (8, 1, 2, 4), (8, 2, 1, 2), (8, 1, 1, 1), (4, 2, 1, 2),
    (4, 1, 1, 1), (2, 1, 2, 1), (1, 1, 1, 1),
]
AXIS_SETS = [a for r in range(len(GRID_AXES) + 1)
             for a in itertools.permutations(GRID_AXES, r)]


def _pair(world, d, m, s):
    return (JTopo(d, m, devices=jax.devices()[:world], seq_parts=s),
            TTopo(d, m, world, seq_parts=s))


@pytest.mark.parametrize("world,d,m,s", GRIDS)
def test_coords_and_global_idx_match_jax(world, d, m, s):
    jt, tt = _pair(world, d, m, s)
    assert tt.grid_shape == jt.grid_shape
    assert tt.replica_count == jt.replica_count
    for p in range(world):
        c = tt.coords(p)
        assert c == jt.coords(p)
        assert tt.global_idx(*c) == jt.global_idx(*c) == p


@pytest.mark.parametrize("world,d,m,s", GRIDS)
def test_group_tables_match_jax(world, d, m, s):
    jt, tt = _pair(world, d, m, s)
    for axes in AXIS_SETS:
        jg, tg = JGroup(jt, axes), TGroup(tt, axes)
        assert tg.size == (jg.size if axes else 1)
        if axes:
            assert tg.member_table() == jcoll._axis_groups_tbl(jg)
        for p in range(world):
            assert tg.group_idx_of(p) == jg.group_idx_of(p)


@pytest.mark.parametrize("world,d,m,s", [(8, 4, 2, 1), (8, 2, 2, 2), (8, 1, 2, 4)])
def test_group_view_rows_are_member_table_rows(world, d, m, s):
    """group_view's (instance, member) layout is the member table's: element
    [c, g] of the view is world rank member_table()[c][g]."""
    _, tt = _pair(world, d, m, s)
    ranks = torch.arange(world).reshape(*tt.grid_shape, 1)
    for axes in AXIS_SETS:
        if not axes:
            continue
        g = TGroup(tt, axes)
        view = tcoll.group_view(ranks, g)[..., 0]
        assert tuple(map(tuple, view.tolist())) == g.member_table()
        assert torch.equal(tcoll.group_unview(view[..., None], g), ranks)


def test_bad_grids_raise():
    with pytest.raises(MLSLError):
        TTopo(3, 1, 8)
    with pytest.raises(MLSLError):
        TTopo(0, 1, 8)
    with pytest.raises(MLSLError):
        TGroup(TTopo(8, 1, 8), ("rows",))
