"""The port's shard planner (``dlrover_tpu_torch/auto/planner.py``)
against the JAX package's, in this process.

The port plans over the JAX model's leaves, which it reads from its own
``param_axes`` and ``jax_coordinates`` and a model on the meta device:
the same (logical axes, shape, bytes) per leaf, in the JAX tree's order,
for the Llama (dense and MoE), GPT (tied and untied), the CNN and DLRM.
With JAX's link rate and collective latency passed, ``plan_rules``
returns JAX's tables, memory, comm and score over the (fsdp 2), (tensor
2) and (fsdp 2, tensor 2) grids for llama_tiny at 64 tokens a step, and
for llama_1b on (tensor 2) at 10 GB and 3 x 2048 tokens (``{'batch':
None, 'layers': 'tensor'}``), and the same error where nothing fits. A
planned table registers as a strategy and trains one step at one rank.
"""

import jax
import numpy as np
import pytest

from dlrover_tpu.auto import planner as jax_planner
from dlrover_tpu.models import cnn as jax_cnn
from dlrover_tpu.models import dlrm as jax_dlrm
from dlrover_tpu.models import gpt as jax_gpt
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu_torch.auto import planner
from dlrover_tpu_torch.models import cnn, dlrm, gpt, llama
from dlrover_tpu_torch.parallel import sharding as shd

from tests.test_torch_llama import one_thread  # noqa: F401

JAX_LINK, JAX_LATENCY = 4.5e10, 5e-6

#: (port config, JAX config, JAX module)
FAMILIES = {
    "llama_tiny": (llama.llama_tiny(), jax_llama.llama_tiny(), jax_llama),
    "llama_moe_tiny": (llama.llama_moe_tiny(), jax_llama.llama_moe_tiny(),
                       jax_llama),
    "gpt_tiny": (gpt.gpt_tiny(), jax_gpt.gpt_tiny(), jax_gpt),
    "gpt_tiny_untied": (gpt.gpt_tiny(tie_lm_head=False),
                        jax_gpt.gpt_tiny(tie_lm_head=False), jax_gpt),
    "mnist_cnn": (cnn.mnist_cnn(), jax_cnn.mnist_cnn(), jax_cnn),
    "criteo_wide_deep": (dlrm.criteo_wide_deep(),
                         jax_dlrm.criteo_wide_deep(), jax_dlrm),
}


def _jax_leaves(jcfg, mod):
    shapes = jax.eval_shape(lambda k: mod.init_params(k, jcfg),
                            jax.random.key(0))
    return shapes, mod.param_axes(jcfg)


@pytest.fixture
def jax_constants(monkeypatch):
    monkeypatch.setattr(planner, "_COLLECTIVE_LATENCY", JAX_LATENCY)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_leaf_infos_are_the_jax_leaves(name):
    cfg, jcfg, mod = FAMILIES[name]
    assert planner.leaf_infos(cfg) == jax_planner._leaf_infos(
        *_jax_leaves(jcfg, mod))


#: (mesh sizes, hbm bytes, the table JAX's planner returns)
GRIDS = [
    ({"fsdp": 2}, 1e6, {"batch": ("fsdp",), "mlp": "fsdp"}),
    ({"tensor": 2}, 1.19e6, {"batch": None, "heads": "tensor"}),
    ({"fsdp": 2, "tensor": 2}, 7.0e5,
     {"batch": ("fsdp",), "embed": "fsdp", "vocab": "tensor"}),
]


@pytest.mark.parametrize("sizes,hbm,table", GRIDS,
                         ids=["fsdp2", "tensor2", "fsdp2_tensor2"])
def test_plan_rules_equals_jax(sizes, hbm, table, jax_constants):
    cfg, jcfg, mod = FAMILIES["llama_tiny"]
    kw = dict(tokens_per_step=64, hidden_size=cfg.hidden_size,
              num_layers=cfg.num_layers)
    got = planner.plan_rules(planner.leaf_infos(cfg), sizes, hbm,
                             link_bandwidth=JAX_LINK, **kw)
    want = jax_planner.plan_rules(*_jax_leaves(jcfg, mod), sizes, hbm, **kw)
    assert got.rules == want.rules == table
    assert (got.memory_bytes, got.comm_seconds, got.score) == pytest.approx(
        (want.memory_bytes, want.comm_seconds, want.score), rel=1e-12)


def test_llama_1b_on_tensor2_owns_layers(jax_constants):
    spec = [("tensor", 2)]
    got = planner.plan_rules_for_llama(llama.llama_1b(), spec, 3, 2048,
                                       10e9, link_bandwidth=JAX_LINK)
    want = jax_planner.plan_rules_for_llama(
        jax_llama.llama_1b(),
        jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("tensor",)),
        3, 2048, 10e9)
    assert got.rules == want.rules == {"batch": None, "layers": "tensor"}
    assert got.score == pytest.approx(want.score, rel=1e-12)


def test_infeasible_raises_as_jax_does(jax_constants):
    with pytest.raises(ValueError, match="no feasible") as got:
        planner.plan_rules_for_llama(llama.llama2_7b(), [("data", 8)], 8,
                                     2048, 16e9, link_bandwidth=JAX_LINK)
    with pytest.raises(ValueError) as want:
        jax_planner.plan_rules_for_llama(
            jax_llama.llama2_7b(),
            jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("data",)),
            8, 2048, 16e9)
    assert str(got.value) == str(want.value)


def test_planned_table_registers_and_trains(one_thread,  # noqa: F811
                                            jax_constants):
    """A table the planner returns is a strategy: registered, the port's
    trainer builds it through the family seam and steps."""
    import torch

    from dlrover_tpu_torch.models import make_trainer_for

    cfg = llama.llama_tiny()
    report = planner.plan_rules_for_llama(cfg, [("fsdp", 2)], 1, 64, 1e6)
    assert report.rules == {"batch": ("fsdp",), "mlp": "fsdp"}
    planner.register_plan("planned_test", report)
    try:
        t = make_trainer_for(cfg, device="cpu", strategy="planned_test")
        t.init(seed=0)
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
        loss = t.train_step(t.shard_batch(t.microbatch((tokens, tokens))))
        assert torch.isfinite(loss) and t.sharded
    finally:
        shd.STRATEGIES.pop("planned_test")
