"""Analytic FLOP count of the fusion model: the denominator of an achieved FLOP rate
(port of the JAX ``utils/flops.py::model_flops_per_pair`` and ``mfu``).

Counts matmul and convolution FLOPs (2*M*N*K per contraction) for one fused IR/VIS pair
at a given input resolution, walking the model's static shape plan
(``ops/shape_plan.py``) stage by stage: 5 encoder + 5 decoder stages x 4 blocks x 2
streams, the patch merge / anti-merge 1x1 convs and the 2-conv final head. Elementwise
work (LayerNorm, softmax, bias adds, activations) is excluded, the convention of MFU
reporting.

The JAX module's cycle models of a TPU's vector and matrix units are not ported; the
port's bounds per kernel are ``chip_smoke.py``'s (``attention_bound_ms``,
``block_bound_ms``, ``repartition_bound_ms``).
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..config import ModelConfig
from ..ops.shape_plan import make_plan

STREAMS = 2


def model_flops_per_pair(cfg: ModelConfig, hw: Tuple[int, int]) -> Dict[str, float]:
    """Matmul/conv FLOPs to fuse ONE IR/VIS pair of resolution ``hw``.

    Returns {"total": float, "per_stage": {...}} with encoder/decoder/head lines.
    """
    h, w = hw
    n = cfg.num_stages
    plan = make_plan(h, w, n, cfg.merging_size, cfg.window_size)
    win = cfg.window_size[0] * cfg.window_size[1]
    heads = cfg.att_num_heads

    per_stage: Dict[str, float] = {}
    total = 0.0

    def block_flops(tokens: int, c: int, mlp_hidden: int) -> float:
        """One transformer block (attention + MLP) for one stream."""
        cp = heads * cfg.dims_per_head(c)  # qkv/proj inner width (= C when C%8==0)
        qkv = 3 * 2 * tokens * c * cp
        scores_av = 2 * (2 * tokens * win * cp)  # QK^T and AV, both over 49 keys
        proj = 2 * tokens * cp * c
        mlp = 2 * tokens * c * mlp_hidden + 2 * tokens * mlp_hidden * c
        return qkv + scores_av + proj + mlp

    for k in range(n):
        p = plan[k]
        mh, mw = p.merged_hw
        ah, aw = p.att_hw
        tokens = ah * aw
        d_in, d_out = cfg.in_dims_list[k], cfg.out_dims_list[k]

        # encoder: space-to-depth (4*d_in) -> 1x1 conv to d_out at merged_hw
        merge = 2 * mh * mw * (4 * d_in) * d_out
        # decoder: 1x1 conv d_out -> 4*d_in at merged_hw, then depth-to-space
        unmerge = 2 * mh * mw * d_out * (4 * d_in)

        enc_mlp_hidden = d_out * cfg.mlp_hidden_dims_ratio
        dec_mlp_hidden = d_in * cfg.mlp_hidden_dims_ratio  # the reference decoder's MLP width
        enc_blocks = 4 * block_flops(tokens, d_out, enc_mlp_hidden)
        dec_blocks = 4 * block_flops(tokens, d_out, dec_mlp_hidden)

        enc = STREAMS * (merge + enc_blocks)
        dec = STREAMS * (unmerge + dec_blocks)
        per_stage[f"enc{k}"] = enc
        per_stage[f"dec{k}"] = dec
        total += enc + dec

    # final head: concat(2ch) -> conv3x3 2->2 -> BN -> ELU -> conv3x3 2->1
    ksq = cfg.final_conv_layer_kernel_size**2
    head = 2 * h * w * ksq * 2 * 2 + 2 * h * w * ksq * 2 * 1
    per_stage["head"] = float(head)
    total += head

    return {"total": float(total), "per_stage": per_stage}


def mfu(pairs_per_sec: float, flops_per_pair: float, peak_tflops: float):
    """(achieved TFLOP/s, fraction of ``peak_tflops``) for a measured throughput. The
    peak is the caller's: the device's rate for the arithmetic the model runs in."""
    achieved = pairs_per_sec * flops_per_pair / 1e12
    return achieved, achieved / peak_tflops
