"""Workload (layer-list) definitions for the paper's evaluation DNNs.

The paper evaluates three CNNs -- MobileNet-V2, MnasNet, ResNet-50 -- and
three GEMM-based models -- GNMT, Transformer, NCF.  Each is lowered to the
(K, C, Y, X, R, S, type) descriptors of ``layers.py``.

Strided convolutions: the cost model computes output spatial dims as
Y' = Y - R + 1, so strided layers are encoded with *effective* input size
Y = Y_out + R - 1 (MAC counts then match the true strided layer).

The assigned architectures (qwen3 / zamba2 / ...) are lowered by
``repro_torch.costmodel.arch_workloads`` from their configs; both
registries, and the ``multi_dnn`` co-design mix, are reachable through
:func:`get_workload`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.costmodel import arch_workloads
from repro_torch.costmodel.layers import LayerSpec


def _conv(K, C, out_y, out_x, R, S, name=""):
    return LayerSpec.conv(K, C, out_y + R - 1, out_x + S - 1, R, S, name=name)


def _dw(C, out_y, out_x, R, S, name=""):
    return LayerSpec.dwconv(C, out_y + R - 1, out_x + S - 1, R, S, name=name)


def mobilenet_v2() -> List[LayerSpec]:
    layers: List[LayerSpec] = [_conv(32, 3, 112, 112, 3, 3, "conv0")]
    cin, res = 32, 112
    # (expansion t, out channels c, repeats n, stride s)
    table = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for t, c, n, s in table:
        for i in range(n):
            stride = s if i == 0 else 1
            out_res = res // stride
            hidden = cin * t
            blk = f"b{len(layers)}"
            if t != 1:
                layers.append(_conv(hidden, cin, res, res, 1, 1,
                                    blk + ".expand"))
            layers.append(_dw(hidden, out_res, out_res, 3, 3, blk + ".dw"))
            layers.append(_conv(c, hidden, out_res, out_res, 1, 1,
                                blk + ".proj"))
            cin, res = c, out_res
    layers.append(_conv(1280, cin, res, res, 1, 1, "conv_last"))
    layers.append(LayerSpec.gemm(1, 1000, 1280, name="fc"))
    return layers


def resnet50() -> List[LayerSpec]:
    layers: List[LayerSpec] = [_conv(64, 3, 112, 112, 7, 7, "conv1")]
    cfg = [(64, 256, 3, 56), (128, 512, 4, 28),
           (256, 1024, 6, 14), (512, 2048, 3, 7)]
    cin = 64
    for width, cout, n, res in cfg:
        for i in range(n):
            blk = f"s{res}.b{i}"
            layers.append(_conv(width, cin, res, res, 1, 1, blk + ".r"))
            layers.append(_conv(width, width, res, res, 3, 3, blk + ".c"))
            layers.append(_conv(cout, width, res, res, 1, 1, blk + ".e"))
            if i == 0:
                layers.append(_conv(cout, cin, res, res, 1, 1, blk + ".d"))
            cin = cout
    layers.append(LayerSpec.gemm(1, 1000, 2048, name="fc"))
    return layers


def mnasnet() -> List[LayerSpec]:
    layers: List[LayerSpec] = [_conv(32, 3, 112, 112, 3, 3, "conv0")]
    layers += [_dw(32, 112, 112, 3, 3, "sep.dw"),
               _conv(16, 32, 112, 112, 1, 1, "sep.pw")]
    cin, res = 16, 112
    # (expansion, out c, n, stride, kernel)
    table = [(3, 24, 3, 2, 3), (3, 40, 3, 2, 5), (6, 80, 3, 2, 5),
             (6, 96, 2, 1, 3), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3)]
    for t, c, n, s, k in table:
        for i in range(n):
            stride = s if i == 0 else 1
            out_res = res // stride
            hidden = cin * t
            blk = f"mb{len(layers)}"
            layers.append(_conv(hidden, cin, res, res, 1, 1, blk + ".expand"))
            layers.append(_dw(hidden, out_res, out_res, k, k, blk + ".dw"))
            layers.append(_conv(c, hidden, out_res, out_res, 1, 1,
                                blk + ".proj"))
            cin, res = c, out_res
    layers.append(_conv(1280, cin, res, res, 1, 1, "conv_last"))
    layers.append(LayerSpec.gemm(1, 1000, 1280, name="fc"))
    return layers


def gnmt(seq: int = 128, hidden: int = 1024, vocab: int = 32000
         ) -> List[LayerSpec]:
    layers: List[LayerSpec] = []
    for l in range(8):  # encoder LSTMs
        layers.append(LayerSpec.gemm(seq, 4 * hidden, hidden,
                                     name=f"enc{l}.W"))
        layers.append(LayerSpec.gemm(seq, 4 * hidden, hidden,
                                     name=f"enc{l}.U"))
    layers.append(LayerSpec.gemm(seq, hidden, hidden, name="attn.q"))
    layers.append(LayerSpec.gemm(seq, seq, hidden, name="attn.score"))
    layers.append(LayerSpec.gemm(seq, hidden, seq, name="attn.ctx"))
    for l in range(8):  # decoder LSTMs
        layers.append(LayerSpec.gemm(seq, 4 * hidden, 2 * hidden,
                                     name=f"dec{l}.W"))
        layers.append(LayerSpec.gemm(seq, 4 * hidden, hidden,
                                     name=f"dec{l}.U"))
    layers.append(LayerSpec.gemm(seq, vocab, hidden, name="softmax"))
    return layers


def transformer(seq: int = 64, d: int = 512, heads: int = 8, ff: int = 2048,
                vocab: int = 37000, n_enc: int = 6, n_dec: int = 6
                ) -> List[LayerSpec]:
    dh = d // heads
    layers: List[LayerSpec] = []

    def attn_block(prefix: str, kv_seq: int):
        return [
            LayerSpec.gemm(seq, 3 * d, d, name=prefix + ".qkv"),
            LayerSpec.gemm(seq, kv_seq, dh, repeat=heads,
                           name=prefix + ".score"),
            LayerSpec.gemm(seq, dh, kv_seq, repeat=heads,
                           name=prefix + ".ctx"),
            LayerSpec.gemm(seq, d, d, name=prefix + ".out"),
        ]

    def ffn_block(prefix: str):
        return [LayerSpec.gemm(seq, ff, d, name=prefix + ".ff1"),
                LayerSpec.gemm(seq, d, ff, name=prefix + ".ff2")]

    for l in range(n_enc):
        layers += attn_block(f"enc{l}.self", seq) + ffn_block(f"enc{l}")
    for l in range(n_dec):
        layers += (attn_block(f"dec{l}.self", seq)
                   + attn_block(f"dec{l}.cross", seq)
                   + ffn_block(f"dec{l}"))
    layers.append(LayerSpec.gemm(seq, vocab, d, name="softmax"))
    return layers


def ncf(batch: int = 1024, embed: int = 128) -> List[LayerSpec]:
    dims = [4 * embed, 2 * embed, embed, embed // 2]
    layers: List[LayerSpec] = []
    cin = 2 * embed  # concat(user, item)
    for i, dout in enumerate(dims):
        layers.append(LayerSpec.gemm(batch, dout, cin, name=f"mlp{i}"))
        cin = dout
    layers.append(LayerSpec.gemm(batch, 1, cin + embed, name="predict"))
    return layers


_PAPER_WORKLOADS: Dict[str, Callable[..., List[LayerSpec]]] = {
    "mobilenet_v2": mobilenet_v2,
    "resnet50": resnet50,
    "mnasnet": mnasnet,
    "gnmt": gnmt,
    "transformer": transformer,
    "ncf": ncf,
}


def multi_dnn(names: List[str] = None, tokens: int = 32) -> List[LayerSpec]:
    """Concatenate several models into one workload (the co-design mix).

    Each member's layers keep their own per-layer (PE, Buf) slots and are
    renamed ``<member>.<layer>``; under LP they share one chip budget,
    under LS one shared design.  ``names`` defaults to every assigned
    architecture; a paper workload's name takes that model.  Layer counts
    are ragged across members.
    """
    if names is None:
        names = arch_workloads.arch_names()
    out: List[LayerSpec] = []
    for n in names:
        if n in _PAPER_WORKLOADS:
            layers = _PAPER_WORKLOADS[n]()
        else:
            layers = arch_workloads.lower_arch(n, tokens=tokens)
        out.extend(dataclasses.replace(l, name=f"{n}.{l.name}")
                   for l in layers)
    return out


def get_workload(name: str, **kwargs) -> List[LayerSpec]:
    """Look up a workload by name (paper models + assigned architectures +
    the ``multi_dnn`` co-design mix)."""
    if name in _PAPER_WORKLOADS:
        return _PAPER_WORKLOADS[name](**kwargs)
    if name == "multi_dnn":
        return multi_dnn(**kwargs)
    return arch_workloads.lower_arch(name, **kwargs)


def workload_names() -> List[str]:
    return sorted(_PAPER_WORKLOADS) + arch_workloads.arch_names()
