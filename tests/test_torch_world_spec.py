"""The port's world-spec ladder (elasticdl_tpu_torch/parallel/mesh.py)
against the JAX package's resolver over a grid of parallel configs and
topologies, the pipeline and ZeRO-1 branches included: equal axes, notes
and fingerprints. And the port's shard layout against JAX's
process-grouped mesh reshape."""

import itertools

import numpy as np
import pytest

from elasticdl_tpu.parallel import mesh as jax_mesh
from elasticdl_tpu_torch.parallel import mesh

# (n_devices, local_devices, n_processes)
TOPOLOGIES = [(1, 1, 1), (2, 2, 1), (4, 4, 1), (8, 8, 1), (8, 4, 2),
              (8, 2, 4), (6, 3, 2), (4, 1, 4), (16, 8, 2), (12, 4, 3)]
CONFIGS = [
    dict(model_parallel=mp, has_param_specs=specs, zero1=zero1,
         pipeline_stages=pp, has_pipeline_spec=pp_spec,
         context_parallel=sp, has_context_parallel_model=cp_model,
         sp_suspended=suspended)
    for mp, specs, zero1, pp, pp_spec, sp, cp_model, suspended
    in itertools.product((1, 2, 4), (True, False), (False, True), (1, 2),
                         (True, False), (1, 2, 3), (True, False),
                         (False, True))
]


def _check(want_mp):
    """A param check that vetoes one model-parallel size."""
    return lambda mp: [f"dim 0 % {mp} != 0"] if mp == want_mp else []


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=str)
def test_resolver_matches_jax(topo):
    for config, check in itertools.product(
            CONFIGS, (None, _check(2), _check(4))):
        want = jax_mesh.resolve_world_spec(
            jax_mesh.ParallelConfig(**config),
            jax_mesh.WorldTopology(*topo), param_check=check)
        got = mesh.resolve_world_spec(
            mesh.ParallelConfig(**config), mesh.WorldTopology(*topo),
            param_check=check)
        assert got.axes == want.axes, (config, topo)
        assert got.notes == want.notes, (config, topo)
        assert got.fingerprint() == want.fingerprint()
        assert (got.tp, got.sp, got.pp, got.zero1, got.process_grouped) == (
            want.tp, want.sp, want.pp, want.zero1, want.process_grouped)


@pytest.mark.parametrize("topo", [(8, 8, 1), (8, 4, 2), (16, 8, 2)],
                         ids=str)
def test_shard_layout_is_the_process_grouped_reshape(topo):
    """Local shard i of process p sits at the coordinates that JAX's flat
    reshape of the process-grouped device list gives device p*L + i."""
    n, local, procs = topo
    for mp, sp in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2)):
        spec = mesh.resolve_world_spec(
            mesh.ParallelConfig(model_parallel=mp, has_param_specs=True,
                                context_parallel=sp,
                                has_context_parallel_model=True),
            mesh.WorldTopology(*topo))
        names = [a for a, _ in spec.axes]
        grid = np.arange(n).reshape([s for _, s in spec.axes])
        for p in range(procs):
            layout = mesh.ShardLayout(spec, p)
            assert layout.data_local * spec.tp * spec.sp == local
            for i in range(local):
                coords = layout.coords(i)
                index = tuple(coords[a] for a in names)
                assert grid[index] == p * local + i


def test_pure_dp_fingerprint_and_current_topology(monkeypatch):
    for n in (1, 2, 5):
        assert mesh.world_fingerprint(n) == jax_mesh.resolve_world_spec(
            jax_mesh.ParallelConfig(),
            jax_mesh.WorldTopology(n, 1, n)).fingerprint()
    monkeypatch.setenv("ELASTICDL_LOCAL_DEVICES", "4")
    assert mesh.local_device_count() == 4
    assert mesh.WorldTopology.current(2) == mesh.WorldTopology(8, 4, 2)
    monkeypatch.delenv("ELASTICDL_LOCAL_DEVICES")
    assert mesh.local_device_count() == 1  # no CUDA device here


@pytest.mark.parametrize("topo", [(4, 4, 1), (8, 4, 2), (16, 8, 2)],
                         ids=str)
def test_stage_axis_layout_and_demand(topo):
    """The stage axis: the process-grouped reshape as for the model and
    seq axes, each process's data positions times the stages its shards,
    and the demand the JAX package's pipeline module makes (the port keeps
    one copy, in parallel/mesh.py)."""
    from elasticdl_tpu.parallel.pipeline import (
        stage_axis_demand as jax_demand,
    )
    from elasticdl_tpu_torch.parallel import pipeline

    assert pipeline.stage_axis_demand is mesh.stage_axis_demand
    assert tuple(mesh.stage_axis_demand(2)) == tuple(jax_demand(2))
    n, local, procs = topo
    spec = mesh.resolve_world_spec(
        mesh.ParallelConfig(pipeline_stages=2, has_pipeline_spec=True),
        mesh.WorldTopology(*topo))
    assert spec.pp == 2 and spec.axes[-1] == (mesh.STAGE_AXIS, 2)
    names = [a for a, _ in spec.axes]
    grid = np.arange(n).reshape([s for _, s in spec.axes])
    for p in range(procs):
        layout = mesh.ShardLayout(spec, p)
        assert layout.data_local * 2 == local
        for i in range(local):
            coords = layout.coords(i)
            assert grid[tuple(coords[a] for a in names)] == p * local + i
            peer = layout.group_key(i, mesh.STAGE_AXIS)
            assert [j for j in range(local) if layout.group_key(
                j, mesh.STAGE_AXIS) == peer] == [i - i % 2, i - i % 2 + 1]
