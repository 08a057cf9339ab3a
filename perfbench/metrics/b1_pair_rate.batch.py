"""B1's rate on the work it is handed (%): ``2 * dim`` operations for each
(query slot, row slot) pair the fused scan's kernel covers (the program's
counter ``ivf_flat.fused.pairs_scanned``, summed over the window), over
B1's device time in the trace, as a share of TF32's dense rate. Divided
by ``b1_overscan.batch`` it is B1's share of its roofline by operations."""
from perfbench import roofline


def read(trace):
    scanned = trace.histogram("ivf_flat.fused.pairs_scanned")
    t = trace.kernel_seconds("ivf_filter_kernel")
    if scanned is None or t <= 0:
        return None
    flops = 2.0 * trace.context["queries"].shape[1] * scanned["sum"]
    trace.notes.append(f"B1 pair rate: {flops:.6g} operations in {t:.6f} s of kernel, "
                       f"{flops / t / 1e12:.6g} TFLOP/s")
    return 100.0 * flops / t / roofline.PEAKS["tf32_flops_per_s"]
