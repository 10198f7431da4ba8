"""An optimizer's state as optax's tree.

:func:`optimizer_state` gives the tree of any of the port's optimizers
(``torch.optim.AdamW``'s through its per-parameter state, the others'
through their ``state_tree``), :func:`load_optimizer_state` copies one
back, and :func:`per_param_leaves` / :func:`map_per_param` walk its
per-parameter lists, which a sharded trainer saves as the boxes of the
JAX leaves.
"""

from typing import Any, Dict, List, Tuple

import torch


def optimizer_state(opt) -> Dict[str, Any]:
    """``opt``'s state as optax's tree: a dict whose leaves are lists
    with one tensor per parameter the optimizer steps (in its order),
    scalars, or such dicts. AdamW's ``{"mu", "nu", "count"}``, Adagrad's
    ``{"sum_of_squares"}``, the wrappers' of ``optim/bf16.py``."""
    if isinstance(opt, torch.optim.AdamW):
        states = [opt.state[p] for g in opt.param_groups
                  for p in g["params"]]
        return {"mu": [s["exp_avg"] for s in states],
                "nu": [s["exp_avg_sq"] for s in states],
                "count": int(states[0]["step"]) if states else 0}
    if not hasattr(opt, "state_tree"):
        raise TypeError(
            f"train state of a {type(opt).__name__}: AdamW "
            "(torch.optim.AdamW or Fp32GradAdamW), RssAdagrad and the "
            "optimizers of optim/bf16.py are carried")
    return opt.state_tree()


def load_optimizer_state(opt, tree: Dict[str, Any]) -> None:
    """:func:`optimizer_state`'s tree copied into ``opt`` in place."""
    if isinstance(opt, torch.optim.AdamW):
        init_adamw_state(opt)
        params = [p for g in opt.param_groups for p in g["params"]]
        for p, m, v in zip(params, tree["mu"], tree["nu"]):
            st = opt.state[p]
            st["exp_avg"].copy_(m)
            st["exp_avg_sq"].copy_(v)
            st["step"].fill_(int(tree["count"]))
        return
    opt.load_state_tree(tree)


def per_param_leaves(tree, path=()) -> List[Tuple[Tuple, List]]:
    """``(key path, list)`` for every per-parameter list of an
    :func:`optimizer_state` tree, in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += per_param_leaves(v, path + (k,))
        elif isinstance(v, list):
            out.append((path + (k,), v))
    return out


def map_per_param(tree, fn):
    """``tree`` with every per-parameter list replaced by ``fn(path,
    list)`` (its scalars kept)."""
    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif isinstance(v, list):
                out[k] = fn(path + (k,), v)
            else:
                out[k] = v
        return out

    return walk(tree, ())


def init_adamw_state(opt: torch.optim.AdamW) -> None:
    """Create AdamW's per-parameter state now, as its first step would
    (zero moments in the parameter's dtype, a step count of 0), so the
    state exists -- and a checkpoint of it has one layout -- from the
    start."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.requires_grad and not opt.state[p]:
                opt.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32),
                    "exp_avg": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                }
