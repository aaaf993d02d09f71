"""K2b (GroupNorm affine + SiLU + 3x3 conv): the least time of its
launches in the traced window, each the larger of its implicit GEMM's
FLOPs over the bf16 peak and its bytes (x, weight, out) over the
bandwidth, over the device time of its kernels in the trace."""

from benchmark import flops


def read(run):
    if run.trace is None:
        return None
    work, _ = flops.traced(run)
    return flops.roofline(run, work.k2b, "gn_silu_conv3x3",
                          "gn_silu_conv3x3_kernel", flops.k2b_cost)
