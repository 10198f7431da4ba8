"""The port's rule tables against the JAX package's, without processes:
for every strategy and the meshes (data 2), (fsdp 2), (tensor 2),
(fsdp 2, tensor 2) and (data 2, fsdp 2), the spec of every llama_tiny
parameter, carried to its JAX leaf through ``jax_coordinates``, equals
the JAX ``tree_shardings`` on the conftest's virtual CPU devices; the
ZeRO optimizer-state and gradient rules, ``resolve_mesh_shape``'s errors
and the DTensor placements of a spec."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel import mesh as jax_mesh
from dlrover_tpu.parallel import sharding as jax_shd
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel import mesh as port_mesh
from dlrover_tpu_torch.parallel import sharding as shd

MESHES = [
    (("data", 2),),
    (("fsdp", 2),),
    (("tensor", 2),),
    (("fsdp", 2), ("tensor", 2)),
    (("data", 2), ("fsdp", 2)),
]


class _Shape:
    """A mesh's shape without ranks: the questions spec_for_axes and
    placements ask a DeviceMesh."""

    def __init__(self, spec):
        self.mesh_dim_names = tuple(n for n, _ in spec)
        self.sizes = [s for _, s in spec]
        self.mesh = torch.arange(int(np.prod(self.sizes))).reshape(
            self.sizes)

    def size(self, mesh_dim=None):
        return self.sizes[mesh_dim]

    def get_coordinate(self):
        return [0] * len(self.sizes)


def _jax_spec(spec, cfg, name):
    """A port parameter's spec as the spec of its JAX leaf (the stacked
    layer dim unsharded), trailing Nones dropped as PartitionSpec does."""
    leaf = llama.jax_coordinates(cfg, name)
    out = [None] * len(leaf.shape)
    for d, entry in enumerate(spec):
        out[leaf.dims[d]] = entry
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("strategy", sorted(shd.STRATEGIES))
@pytest.mark.parametrize("spec", MESHES, ids=lambda s: "x".join(
    f"{n}{k}" for n, k in s))
def test_specs_equal_the_jax_tree_shardings(strategy, spec):
    jcfg, cfg = jax_llama.llama_tiny(), llama.llama_tiny()
    n = int(np.prod([k for _, k in spec]))
    jmesh = JaxMesh(np.asarray(jax.devices()[:n]).reshape(
        [k for _, k in spec]), tuple(a for a, _ in spec))
    rules = shd.get_rules(strategy)
    assert rules == jax_shd.get_rules(strategy)
    want = jax_shd.tree_shardings(jax_llama.param_axes(jcfg), jmesh,
                                  jax_shd.get_rules(strategy))
    mesh = _Shape(spec)
    axes = llama.param_axes(cfg)
    leaves = set()
    for name, p in llama.Llama(cfg, device="cpu").named_parameters():
        leaf = llama.jax_coordinates(cfg, name)
        got = shd.spec_in_order(axes[name], leaf.dims, rules, mesh)
        assert len(got) == p.dim(), name
        leaves.add(leaf.path)
        assert _jax_spec(got, cfg, name) == tuple(
            _leaf(want, leaf.path).spec), (strategy, spec, name)
    # every JAX leaf is some port parameter's
    assert leaves == {tuple(k.key for k in path) for path, _ in
                      jax.tree_util.tree_flatten_with_path(
                          jax_llama.param_axes(jcfg),
                          is_leaf=lambda x: isinstance(x, tuple))[0]}
    # the batch's spec, as batch_sharding gives it
    batch = shd.spec_for_axes(("batch",), rules, mesh)
    assert tuple(e for e in batch if e is not None) == tuple(
        jax_shd.batch_sharding(jmesh, rules).spec)


@pytest.mark.parametrize("strategy", sorted(shd.STRATEGIES))
def test_zero_rules_equal_jax(strategy):
    assert shd.opt_state_rules(strategy) == jax_shd.opt_state_rules(strategy)
    assert shd.grad_rules(strategy) == jax_shd.grad_rules(strategy)


@pytest.mark.parametrize("spec,n", [
    ([("data", -1), ("fsdp", -1)], 4),
    ([("data", 0)], 4),
    ([("data", -1), ("fsdp", 3)], 4),
    ([("data", 2), ("fsdp", 3)], 4),
    ([("data", 2), ("fsdp", -1)], 8),
    ([("fsdp", 4)], 4),
])
def test_resolve_mesh_shape_raises_where_jax_raises(spec, n):
    try:
        want = jax_mesh.resolve_mesh_shape(spec, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_mesh.resolve_mesh_shape(spec, n)
        assert str(got.value) == str(e)
    else:
        assert port_mesh.resolve_mesh_shape(spec, n) == want


def test_axis_names_and_batch_axes_copy_jax():
    assert port_mesh.CANONICAL_ORDER == jax_mesh.CANONICAL_ORDER
    mesh = _Shape((("data", 2), ("fsdp", 2), ("tensor", 2)))
    assert port_mesh.batch_axes(mesh) == ("data", "fsdp")
    assert port_mesh.data_parallel_size(mesh) == 4
    assert port_mesh.mesh_info(mesh) == {"data": 2, "fsdp": 2, "tensor": 2}
    assert port_mesh.axis_size(mesh, "pipe") == 1


def test_placements_and_boxes():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Shape((("fsdp", 2), ("tensor", 2)))
    spec = shd.spec_for_axes(("heads", "embed"),
                             shd.get_rules("tp_fsdp"), mesh)
    assert spec == ("tensor", "fsdp")
    # fsdp's first axis in the JAX order (embed, heads) is embed
    assert shd.spec_in_order(("heads", "embed"), (1, 0),
                             shd.get_rules("fsdp"), mesh) == (None, "fsdp")
    assert shd.spec_for_axes(("heads", "embed"), shd.get_rules("fsdp"),
                             mesh) == ("fsdp", None)
    assert shd.placements(spec, mesh) == [Shard(1), Shard(0)]
    assert shd.placements((None, None), mesh) == [Replicate(), Replicate()]
    boxes = shd.global_boxes(spec, (8, 4), mesh)
    # rank = fsdp * 2 + tensor: rows by tensor, columns by fsdp
    assert boxes == [([(0, 4), (0, 2)], [0]), ([(4, 8), (0, 2)], [1]),
                     ([(0, 4), (2, 4)], [2]), ([(4, 8), (2, 4)], [3])]
    norm = shd.global_boxes((None,), (8,), mesh)
    assert norm == [([(0, 8)], [0, 1, 2, 3])]
    with pytest.raises(ValueError, match="does not split"):
        shd.local_slices(("fsdp",), (3,), mesh)


def test_single_rank_mesh_without_a_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = port_mesh.create_mesh([("data", 1), ("fsdp", -1)], device="cpu")
    assert isinstance(mesh, port_mesh.SingleRankMesh)
    assert port_mesh.mesh_info(mesh) == {"data": 1, "fsdp": 1}
    assert port_mesh.axes_group(mesh, ("data", "fsdp")) is None
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        port_mesh.create_mesh([("fsdp", 2)], device="cpu")
    # the DCN axes outermost, the ICI axes resolved against the rest
    hybrid = port_mesh.create_hybrid_mesh([("fsdp", -1), ("tensor", 1)],
                                          [("data", 1)], device="cpu")
    assert port_mesh.axis_names(hybrid) == ("data", "fsdp", "tensor")


@pytest.mark.parametrize("name", ["embed", "lm_head.weight", "final_norm",
                                  "blocks.1.wq.weight", "blocks.0.w_down.weight",
                                  "blocks.1.mlp_norm"])
def test_jax_coordinates_carry_params_from_jax(name):
    """jax_coordinates is params_from_jax's mapping: each port parameter
    is the box of its JAX leaf it names, in to_jax's order."""
    jcfg = jax_llama.llama_tiny(dtype=np.float32)
    cfg = llama.llama_tiny(dtype=torch.float32)
    tree = jax.tree.map(np.asarray,
                        jax_llama.init_params(jax.random.key(0), jcfg))
    model = llama.params_from_jax(tree, cfg, device="cpu")
    p = dict(model.named_parameters())[name].detach()
    leaf = llama.jax_coordinates(cfg, name)
    whole = _leaf(tree, leaf.path)
    assert tuple(whole.shape) == leaf.shape
    box = leaf.index([[0, n] for n in p.shape])
    got = whole[tuple(slice(a, b) for a, b in box)]
    assert np.array_equal(leaf.to_jax(p).numpy(), got)
    assert torch.equal(leaf.from_jax(leaf.to_jax(p)), p)
