"""B1 (``ivf_filter_kernel``, csrc/ivf_scan.cu) against its roofline (%):
the bound of each call's work (:func:`perfbench.roofline.ivf_flat_scan`)
over B1's device time in the trace."""
from perfbench import roofline
from perfbench.metrics._roofline import share


def read(trace):
    c = trace.context
    work = roofline.ivf_flat_scan(c["view"], c["queries"],
                                  n_probes=c["config"]["search"]["n_probes"],
                                  k=c["config"]["k"])
    return share(trace, "ivf_filter_kernel", work, "B1")
