"""Ops of the port: plain PyTorch versions and the wrappers of the CUDA kernels."""


def kernel_wrappers() -> dict:
    """name -> launch counter of every CUDA kernel: an object with an integer
    ``launches`` count, raised by one at each launch of its kernel. A GEMM or
    norm kernel's counter is its wrapper, but that the W8A16 GEMM has one
    per weight type (``matmul_w8a16`` for int8 weights, ``matmul_w8a16_fp8``
    for float8_e4m3fn ones); the paged-attention kernel has one counter per
    instantiation (KV entry type): ``paged_attention`` for the
    bf16 cache, ``paged_attention_<kv dtype>`` for the 8-bit ones; each of
    those also counts its launches under a sliding window in
    ``window_launches``, with a logit softcap in ``softcap_launches``, of
    its head-dim-256 instantiation in ``d256_launches``, under a Medusa
    tree mask in ``tree_launches`` and of its ALiBi instantiation in
    ``alibi_launches``; a norm's launches with the residual add are also
    counted in its ``fused_launches``, and rmsnorm's with a gamma in its
    ``gamma_launches``."""
    import torch
    from qspec_tpu_torch.ops.attention_cuda import LAUNCHES
    from qspec_tpu_torch.ops.linear_kernels import (matmul_w4a4, matmul_w4a16,
                                                    matmul_w4a16_g, matmul_w8a16,
                                                    matmul_w8a16_fp8)
    from qspec_tpu_torch.ops.rmsnorm_quant import rmsnorm, rmsnorm_quant
    return {"matmul_w4a16": matmul_w4a16, "matmul_w4a16_g": matmul_w4a16_g,
            "matmul_w4a4": matmul_w4a4,
            "matmul_w8a16": matmul_w8a16, "matmul_w8a16_fp8": matmul_w8a16_fp8,
            "rmsnorm": rmsnorm, "rmsnorm_quant": rmsnorm_quant,
            "paged_attention": LAUNCHES[torch.bfloat16],
            "paged_attention_int8": LAUNCHES[torch.int8],
            "paged_attention_fp8_e4m3": LAUNCHES[torch.float8_e4m3fn],
            "paged_attention_fp8_e5m2": LAUNCHES[torch.float8_e5m2]}
