"""Attention cores, preprocessing and the hand-written CUDA kernels' wrappers."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter by name: the fused forward and
    backward, the talking-heads forward and its two backward kernels, the
    flash forward, dq and dk/dv, the same three of the relative-position
    family, and the int8 arm's quantize (Q1) and GEMM (Q2). A wrapper adds
    one where it launches its kernel (on the CPU it runs the plain version
    and adds nothing); a replayed CUDA graph moves none of them."""
    from sav_tpu_torch.ops import flash_attention as flash
    from sav_tpu_torch.ops import fused_attention as fa
    from sav_tpu_torch.ops import quant
    from sav_tpu_torch.ops import talking_heads as th

    return {"fused": fa.LAUNCHES, "fused_bwd": fa.BWD_LAUNCHES,
            "talking_heads": th.LAUNCHES, "talking_heads_bwd": th.BWD_LAUNCHES,
            "talking_heads_bwd_dkv": th.BWD_DKV_LAUNCHES,
            "flash": flash.LAUNCHES, "flash_dq": flash.BWD_DQ_LAUNCHES,
            "flash_dkv": flash.BWD_DKV_LAUNCHES, "rel": flash.REL_LAUNCHES,
            "rel_dq": flash.REL_BWD_DQ_LAUNCHES, "rel_dkv": flash.REL_BWD_DKV_LAUNCHES,
            "int8_quant": quant.QUANT_LAUNCHES, "int8_gemm": quant.GEMM_LAUNCHES}


def variant_counts() -> dict:
    """The launches of :func:`launch_counts`, by counter and then by the
    variant that ran (``tensor_core`` or ``cuda_core``; Q1 always runs on
    the CUDA cores, Q2 on the tensor cores): copies of each wrapper's tally,
    which it adds to where it adds to its counter."""
    from sav_tpu_torch.ops import flash_attention as flash
    from sav_tpu_torch.ops import fused_attention as fa
    from sav_tpu_torch.ops import quant
    from sav_tpu_torch.ops import talking_heads as th

    tallies = {"fused": fa.FWD_VARIANT_LAUNCHES, "fused_bwd": fa.BWD_VARIANT_LAUNCHES,
               "talking_heads": th.VARIANT_LAUNCHES,
               "talking_heads_bwd": th.BWD_VARIANT_LAUNCHES,
               "talking_heads_bwd_dkv": th.BWD_DKV_VARIANT_LAUNCHES,
               "flash": flash.VARIANT_LAUNCHES, "flash_dq": flash.BWD_DQ_VARIANT_LAUNCHES,
               "flash_dkv": flash.BWD_DKV_VARIANT_LAUNCHES, "rel": flash.REL_VARIANT_LAUNCHES,
               "rel_dq": flash.REL_BWD_DQ_VARIANT_LAUNCHES,
               "rel_dkv": flash.REL_BWD_DKV_VARIANT_LAUNCHES,
               "int8_quant": quant.QUANT_VARIANT_LAUNCHES,
               "int8_gemm": quant.GEMM_VARIANT_LAUNCHES}
    return {kind: dict(tally) for kind, tally in tallies.items()}


def reset_launches() -> None:
    """Set every counter of :func:`launch_counts`, and the tallies by
    variant, to 0."""
    from sav_tpu_torch.ops import flash_attention as flash
    from sav_tpu_torch.ops import fused_attention as fa
    from sav_tpu_torch.ops import quant
    from sav_tpu_torch.ops import talking_heads as th

    fa.reset_launches()
    th.reset_launches()
    flash.reset_launches()
    quant.reset_launches()
