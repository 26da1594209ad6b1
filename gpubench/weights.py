"""Weight trees for both sides: drawn on the device from the seed, or read
from a checkpoint's ``.npz``. The tree is the nested dict/list layout the
program's functional entry takes (``params/fb/stack/layers/0/weight_ih``),
made here so that the reference never reads a weight the program made."""

from __future__ import annotations

import hashlib
import math
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .reference import sections


def _layers(prefix: str, fin: int, H: int, L: int, shared: bool, bn: bool, pre_ln: bool,
            proj: int) -> List[Tuple[str, Tuple[int, ...], Any]]:
    """(path, shape, init) of one sequence model: init is a uniform bound,
    "ones" or "zeros"."""
    out = []
    if pre_ln:
        out += [(f"params/{prefix}/pre_ln/weight", (fin,), "ones"),
                (f"params/{prefix}/pre_ln/bias", (fin,), "zeros")]
    rows = H if shared else 2 * H
    b = 1.0 / math.sqrt(H)
    for k in range(L):
        lp, ls = f"params/{prefix}/stack/layers/{k}", f"state/{prefix}/stack/layers/{k}"
        out += [(f"{lp}/weight_ih", (rows, fin if k == 0 else H), b),
                (f"{lp}/weight_hh", (rows, H), b), (f"{lp}/bias_ih", (2 * H,), b)]
        if bn:
            out += [(f"{lp}/bn/weight", (H,), "ones"), (f"{lp}/bn/bias", (H,), "zeros"),
                    (f"{ls}/bn/running_mean", (H,), "zeros"),
                    (f"{ls}/bn/running_var", (H,), "ones")]
    pb = 1.0 / math.sqrt(H)
    out += [(f"params/{prefix}/proj/weight", (proj, H), pb),
            (f"params/{prefix}/proj/bias", (proj,), pb)]
    return out


def leaf_specs(g: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], Any]]:
    """Every leaf of the model's tree with torch's default initialisation."""
    out = _layers("fb", g["fb_in"], g["fb_H"], g["fb_L"], g["shared"], g["bn"], g["pre_ln_fb"],
                  g["fb_P"])
    for i, s in enumerate(sections(g)):
        out += _layers(f"sb/{i}", s["in"], g["sb_H"], g["sb_L"], g["shared"], g["bn"],
                       g["pre_ln_sb"], s["proj"])
    return out


def tree_from_paths(flat: Dict[str, torch.Tensor]) -> Tuple[Any, Any]:
    """``{"params/a/0/b": t}`` -> (params, state) trees; numbered levels
    become lists."""
    root: Dict[str, Any] = {}
    for path, t in flat.items():
        node = root
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    root = lists(root)
    return root["params"], root.get("state", {})


def seeded(g: Dict[str, Any], seed: int, device: torch.device) -> Tuple[Any, Any]:
    """Float32 weights on ``device``: one uniform draw from a generator on
    the device, cut into the leaves and scaled by each leaf's bound."""
    specs = leaf_specs(g)
    total = sum(math.prod(shape) for _, shape, init in specs if not isinstance(init, str))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, "weights"))
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    flat, off = {}, 0
    for path, shape, init in specs:
        if init == "ones":
            flat[path] = torch.ones(shape, device=device)
        elif init == "zeros":
            flat[path] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            flat[path] = (u[off:off + n] * init).reshape(shape)
            off += n
    return tree_from_paths(flat)


def from_npz(path: Path, device: torch.device) -> Tuple[Any, Any]:
    """A checkpoint's ``params/...`` and ``state/...`` arrays as float32 trees."""
    with np.load(path) as z:
        flat = {k: torch.as_tensor(np.asarray(z[k], dtype=np.float32)).to(device) for k in z.files}
    return tree_from_paths(flat)


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Path -> tensor of a nested dict/list tree, in the tree's order."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return [clone(v) for v in tree]


def seed_of(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
