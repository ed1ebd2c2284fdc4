"""B1 (csrc/fused_trace.cu: the packet weights, their order and the fused
generate + trace + histogram) over the traced slice, against the work its
rays need (rooflines/work.py)."""

from benchmarks.harness.readers import roofline

KERNELS = ("fused_trace_kernel", "packet_weight_kernel", "packet_order_kernel")


def read(run):
    return roofline(run, KERNELS)
