"""Mixtral at widths one card cannot hold (Mixtral-8x22B): the weights
drawn layer by layer when asked for, and :mod:`mistral`'s float32 forward
pass over them.

* :func:`make_weights` returns the usual weight dict, but its ``layers`` is
  a :class:`LazyLayers`: layer ``i`` is drawn when it is asked for, on the
  sequence's device, from a generator seeded by ``(seed, i)`` alone, so
  every draw of it gives the same tensors. Dense matrices come in one draw,
  the experts one at a time through a bf16 scratch of one expert, with the
  distributions and codes of ``mistral.py`` (dense normal / sqrt(fan_in) in
  bf16, norm gains 1 + 0.1 normal in float32, expert codes e4m3 of 64
  normal at scale 1 / (64 sqrt(fan_in)) an expert). No whole model is ever
  held: a loop over the layers holds one or two.
* :func:`for_sharding` gives the same weights as the engine's
  ``shard_weights`` is to take them: each layer, once drawn, is copied into
  pinned host memory and its device tensors dropped. ``shard_weights``
  slices each rank's share out of a layer and moves it to the rank's card;
  a share cut from a tensor that already lies on that card would be a view
  that keeps the whole layer alive there, so the layer is handed over from
  the host and each card keeps its share alone.
* :func:`logits` is ``mistral.py``'s pass (TF32 off, layer by layer), over
  the lazy layers: the whole, unsharded layer, independent of the sharding,
  the collective and expert parallelism. ``precision="control"`` is as in
  ``mistral.py``.
"""

from __future__ import annotations

import importlib.util
import math
import os
from collections.abc import Sequence

import numpy as np
import torch


def _sibling(name: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name + ".py")
    spec = importlib.util.spec_from_file_location("servebench_reference_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_mistral = _sibling("mistral")
E4M3, E4M3_MAX, CODE_STD = _mistral.E4M3, _mistral.E4M3_MAX, _mistral.CODE_STD
TOP = -1  # the stream of the leaves outside the layers


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``stream`` of ``seed`` (a layer's index,
    or :data:`TOP`)."""
    a, b = np.random.SeedSequence([int(seed) % 2**64, stream % 2**32]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def _generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def _dense_shapes(m: dict) -> list:
    h, d = m["hidden"], m["head_dim"]
    shapes = [("wqkv", (h, (m["q_heads"] + 2 * m["kv_heads"]) * d), h),
              ("wo", (m["q_heads"] * d, h), m["q_heads"] * d)]
    if m.get("moe"):
        return shapes + [("router", (h, m["moe"]["num_experts"]), h)]
    return shapes + [("w_gate_up", (h, 2 * m["intermediate"]), h),
                     ("w_down", (m["intermediate"], h), m["intermediate"])]


def draw_layer(m: dict, seed: int, i: int, device, host: bool = False) -> dict:
    """Layer ``i`` of model ``m`` drawn on ``device``; with ``host`` each
    tensor is then held in pinned host memory (the experts copied out one at
    a time), and nothing of the layer stays on the device."""
    gen = _generator(device, seed, i)
    h = m["hidden"]

    def out(t):
        if not host:
            return t
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return pinned.copy_(t)

    shapes = _dense_shapes(m)
    flat = torch.empty(sum(math.prod(s) for _, s, _ in shapes), dtype=torch.bfloat16, device=device)
    flat.normal_(generator=gen)
    norms = torch.empty((2, h), dtype=torch.float32, device=device).normal_(generator=gen).mul_(0.1).add_(1.0)
    layer, off = {"attn_norm": out(norms[0]), "mlp_norm": out(norms[1])}, 0
    for name, shape, fan_in in shapes:
        n = math.prod(shape)
        layer[name] = out(flat[off : off + n].view(shape).mul_(1.0 / math.sqrt(fan_in)))
        off += n
    del flat, norms
    moe = m.get("moe")
    if moe:
        e, inter = moe["num_experts"], moe["expert_intermediate"]
        scratch = torch.empty(2 * inter * h, dtype=torch.bfloat16, device=device)
        for name, shape, fan_in in (("moe_gate_up", (2 * inter, h), h), ("moe_down", (h, inter), inter)):
            codes = torch.empty((e, *shape), dtype=E4M3, pin_memory=True) if host else \
                torch.empty((e, *shape), dtype=E4M3, device=device)
            for x in range(e):  # one expert at a time
                g = scratch[: math.prod(shape)].view(shape).normal_(generator=gen)
                codes[x].copy_(g.mul_(CODE_STD).clamp_(-E4M3_MAX, E4M3_MAX).to(E4M3))
            layer[name] = codes
            layer[name + "_scale"] = out(torch.full((e,), 1.0 / (CODE_STD * math.sqrt(fan_in)),
                                                    dtype=torch.float32, device=device))
        del scratch
    return layer


class LazyLayers(Sequence):
    """The layers of model ``m``, each drawn by :func:`draw_layer` when it is
    asked for and held by no one here: two readings of ``[i]`` are equal
    tensors, drawn twice."""

    def __init__(self, m: dict, seed: int, device, host: bool = False):
        self.m, self.seed, self.device, self.host = m, int(seed), torch.device(device), host

    def __len__(self) -> int:
        return self.m["layers"]

    def __getitem__(self, i: int) -> dict:
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        return draw_layer(self.m, self.seed, i % len(self), self.device, self.host)


def make_weights(m: dict, seed: int, device) -> dict:
    """The weights of model ``m`` from ``seed``: the embedding, final norm,
    LM head and RoPE table drawn on ``device`` now (one stream of their
    own), the layers lazily on ``device`` (:class:`LazyLayers`)."""
    gen = _generator(device, seed, TOP)
    h = m["hidden"]
    embed = torch.empty((m["vocab"], h), dtype=torch.bfloat16, device=device).normal_(generator=gen)
    final_norm = torch.empty(h, dtype=torch.float32, device=device).normal_(generator=gen).mul_(0.1).add_(1.0)
    return {
        "embed": embed,
        "final_norm": final_norm,
        "lm_head": _mistral._lin(gen, (h, m["vocab"]), h, device),
        "layers": LazyLayers(m, seed, device),
        "cos_sin": _mistral.cos_sin_table(m["max_position"], m["head_dim"], m["rope_base"], device),
    }


def for_sharding(weights: dict) -> dict:
    """``weights`` with each layer staged through pinned host memory when
    drawn (see the module's docstring); the other leaves as they are. On
    the CPU there is nothing to stage."""
    lz = weights["layers"]
    if lz.device.type == "cpu":
        return weights
    return {**weights, "layers": LazyLayers(lz.m, lz.seed, lz.device, host=True)}


# mistral.py's pass walks ``weights["layers"]`` once, layer by layer: over
# the lazy layers it holds one drawn layer at a time
logits = _mistral.logits
