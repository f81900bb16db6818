"""The port's mesh (kubeflow_tpu_torch/parallel/mesh.py) against the JAX
package's kubeflow_tpu/parallel/mesh.py.

Pure logic, held to the JAX functions over one table of cases each:
``MeshSpec.sizes`` (inferred axis, explicit sizes, and every error with
its message), ``logical_spec`` (the JAX ``PartitionSpec``'s entries, as
a tuple) and the rule table itself.  Then one job of 4 gloo ranks (JAX-
free subprocesses joined with a timeout) builds meshes whose process
groups must hold, along each axis, the ranks the JAX mesh puts along it
(its device grid over the same 4 devices, laid out in ``AXIS_ORDER``),
and whose FSDP2 mesh is the fsdp group with data x sequence as its
replicate dim.  With ``tensor`` = 2 the FSDP2 mesh and the batch group
(``batch_group``, over which the loss is summed) hold only the ranks of
the rank's own tensor index: FSDP2 never joins ranks that hold
different tensor slices.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

from kubeflow_tpu.parallel import mesh as jax_mesh
from kubeflow_tpu_torch.parallel import mesh
from kubeflow_tpu_torch.runtime import topology
from kubeflow_tpu_torch.testing.ranks import check_ranks, run_ranks

REPO = str(Path(__file__).resolve().parents[1])

SIZES = [
    (dict(tensor=2), 8),
    (dict(data=3, tensor=2), 8),
    (dict(tensor=0), 8),
    (dict(tensor=-2), 8),
    (dict(data=-1, fsdp=-1), 8),
    (dict(tensor=3), 8),
    (dict(data=2, fsdp=2, sequence=2), 8),
    (dict(data=1), 1),
    (dict(fsdp=4, sequence=2), 8),
    (dict(), 4),
]


@pytest.mark.parametrize("kw,n", SIZES)
def test_sizes_match_jax(kw, n):
    try:
        want = jax_mesh.MeshSpec(**kw).sizes(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.MeshSpec(**kw).sizes(n)
        assert str(got.value) == str(e)
        return
    assert mesh.MeshSpec(**kw).sizes(n) == want


SPECS = [
    ("embed", "mlp"), ("batch", "seq", "act_embed"), ("vocab", "heads"),
    ("mystery", "mlp"), ("mlp", "norm"), ("embed", "heads", "kv"),
    (None, "embed", "heads", "kv"), ("heads", "kv", "embed"),
    ("layers", "embed", "mlp"), ("expert", "embed", "mlp"), (),
    ("vocab", "embed"), ("norm",),
]


@pytest.mark.parametrize("axes", SPECS)
def test_logical_spec_matches_jax(axes):
    assert mesh.logical_spec(axes) == tuple(jax_mesh.logical_spec(axes))


def test_rule_table_and_axes_are_the_jax_packages():
    assert mesh.AXIS_ORDER == jax_mesh.AXIS_ORDER
    assert mesh.DEFAULT_RULES == jax_mesh.DEFAULT_RULES
    assert mesh.rules_to_dict(mesh.DEFAULT_RULES) == \
        jax_mesh.rules_to_dict(jax_mesh.DEFAULT_RULES)
    assert mesh.MeshSpec().dp_axes == jax_mesh.MeshSpec().dp_axes


@pytest.mark.parametrize("axes,dim", [
    (("embed", "heads", "kv"), 0), ((None, "embed", "heads", "kv"), 1),
    (("heads", "kv", "embed"), 2), (("mlp", "embed"), 1),
    (("vocab", "embed"), 1), (("norm",), None),
])
def test_sharded_dim_is_the_fsdp_entry(axes, dim):
    assert mesh.sharded_dim(axes, mesh.FSDP) == dim


@pytest.mark.parametrize("shape", ["cpu-1", "h100-1", "h100-8"])
def test_topology_builds_on_a_matching_count(shape):
    """``build(topology=)`` on a job of one rank: a one-device shape
    builds the mesh, the 8-GPU one raises before any group is made."""
    import torch.distributed as dist

    topo = topology.get_topology(shape)
    before = dist.is_initialized()
    if topo.devices != 1:
        with pytest.raises(ValueError, match="expects 8 devices, runtime "
                                             "sees 1"):
            mesh.MeshSpec(data=1).build("cpu", topology=topo)
        assert dist.is_initialized() == before
        return
    try:
        dm = mesh.MeshSpec(data=1).build("cpu", topology=topo)
        assert tuple(dm.shape) == (1,) * len(mesh.AXIS_ORDER)
    finally:
        if not before:  # the group this build started
            dist.destroy_process_group()


# Each rank builds these meshes and prints, per mesh, the ranks of its
# group along every axis and the FSDP2 mesh's grid.
_BUILD = """
import json, sys
from kubeflow_tpu_torch.parallel import mesh as m
from kubeflow_tpu_torch.runtime import bootstrap
import torch.distributed as dist
bootstrap.initialize(device="cpu", timeout_s=60)
out = []
for kw in json.loads(sys.argv[1]):
    dm = m.MeshSpec(**kw).build("cpu", timeout_s=60)
    out.append({"groups": {a: dist.get_process_group_ranks(dm.get_group(a))
                           for a in m.AXIS_ORDER},
                "coords": {a: dm.get_local_rank(a) for a in m.AXIS_ORDER},
                "fsdp_mesh": m.fsdp_mesh(dm).mesh.tolist(),
                "fsdp_names": list(m.fsdp_mesh(dm).mesh_dim_names),
                "batch": dist.get_process_group_ranks(m.batch_group(dm)),
                "tensor_shard": list(m.tensor_shard(dm))})
print("MESH " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""
BUILDS = [dict(data=2, sequence=2), dict(fsdp=2, sequence=2),
          dict(data=2, fsdp=2), dict(sequence=4), dict(data=1, fsdp=-1)]
TENSOR_BUILDS = [dict(data=2, tensor=2), dict(fsdp=2, tensor=2),
                 dict(sequence=2, tensor=2)]


@pytest.fixture(scope="module")
def built():
    results = run_ranks(["-c", _BUILD, json.dumps(BUILDS + TENSOR_BUILDS)],
                        4,
                        timeout_s=120, cwd=REPO, threads=1)
    check_ranks(results)
    return [json.loads(next(ln for ln in r.stdout.splitlines()
                            if ln.startswith("MESH "))[5:])
            for r in results]


@pytest.mark.parametrize("i", range(len(BUILDS + TENSOR_BUILDS)))
def test_build_groups_follow_axis_order(built, i):
    """Along each axis a rank's group is the JAX mesh's device slice
    through that rank, and its coordinates are its place in the grid."""
    grid = np.vectorize(lambda d: d.id)(jax_mesh.MeshSpec(
        **(BUILDS + TENSOR_BUILDS)[i]).build(jax.devices()[:4]).devices)
    for rank, per_rank in enumerate(built):
        got = per_rank[i]
        where = tuple(int(c[0]) for c in np.nonzero(grid == rank))
        for dim, axis in enumerate(mesh.AXIS_ORDER):
            index = list(where)
            index[dim] = slice(None)
            assert got["groups"][axis] == grid[tuple(index)].tolist(), axis
            assert got["coords"][axis] == where[dim], axis


@pytest.mark.parametrize("i", range(len(BUILDS)))
def test_fsdp_mesh_replicates_over_data_and_sequence(built, i):
    sizes = mesh.MeshSpec(**BUILDS[i]).sizes(4)
    grid = np.arange(4).reshape([sizes[a] for a in mesh.AXIS_ORDER])
    replicate = sizes[mesh.DATA] * sizes[mesh.SEQUENCE]
    want = grid.transpose(0, 4, 1, 2, 3, 5).reshape(replicate, -1)
    for per_rank in built:
        got = per_rank[i]
        if replicate == 1:
            assert got["fsdp_names"] == [mesh.FSDP]
            mine = [row for row in want.tolist()
                    if got["groups"][mesh.FSDP][0] in row]
            assert [got["fsdp_mesh"]] == mine
        else:
            assert got["fsdp_names"] == ["replicate", mesh.FSDP]
            assert got["fsdp_mesh"] == want.tolist()


@pytest.mark.parametrize("i", range(len(TENSOR_BUILDS)))
def test_fsdp_mesh_never_joins_tensor_indices(built, i):
    """With tensor=2 a rank's FSDP2 mesh and batch group hold exactly
    the ranks that share its tensor index (the JAX grid's slice at that
    index), laid out as replicate (data x sequence) by fsdp."""
    sizes = mesh.MeshSpec(**TENSOR_BUILDS[i]).sizes(4)
    grid = np.arange(4).reshape([sizes[a] for a in mesh.AXIS_ORDER])
    replicate = sizes[mesh.DATA] * sizes[mesh.SEQUENCE]
    for rank, per_rank in enumerate(built):
        got = per_rank[len(BUILDS) + i]
        t = got["coords"][mesh.TENSOR]
        assert got["tensor_shard"] == [t, 2]
        mine = grid[..., t]
        want = mine.transpose(0, 4, 1, 2, 3).reshape(replicate, -1)
        flat = np.asarray(got["fsdp_mesh"]).reshape(replicate, -1)
        assert flat.tolist() == want.tolist()
        assert sorted(got["batch"]) == sorted(mine.flatten().tolist())
        assert rank in got["batch"]
