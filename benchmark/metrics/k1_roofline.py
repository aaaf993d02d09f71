"""K1 (flash attention): the least time of its launches in the traced
window, each the larger of its FLOPs (QK^T and PV at the true head size)
over the bf16 peak and its bytes (q, k, v read once, o written once) over
the bandwidth, over the device time of its kernels in the trace."""

from benchmark import flops


def read(run):
    if run.trace is None:
        return None
    work, _ = flops.traced(run)
    return flops.roofline(run, work.k1, "flash_attention",
                          "flash_fwd_kernel", flops.k1_cost)
