"""Ops of the port: plain PyTorch versions and the wrappers of the CUDA kernels."""


def kernel_wrappers() -> dict:
    """name -> wrapper of every CUDA kernel; each wrapper carries an integer
    ``launches`` count, raised by one at each launch of its kernel."""
    from qspec_tpu_torch.ops.attention_cuda import paged_attention_cuda
    from qspec_tpu_torch.ops.linear_kernels import matmul_w4a4, matmul_w4a16
    from qspec_tpu_torch.ops.rmsnorm_quant import rmsnorm, rmsnorm_quant
    return {"matmul_w4a16": matmul_w4a16, "matmul_w4a4": matmul_w4a4,
            "rmsnorm": rmsnorm, "rmsnorm_quant": rmsnorm_quant,
            "paged_attention": paged_attention_cuda}
