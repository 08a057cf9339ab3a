"""B1's over-scan (x): the (query slot, row slot) pairs the fused scan's
kernel covers, the program's counter ``ivf_flat.fused.pairs_scanned``
summed over the window, over the (query, filled row of its own lists)
pairs of the calls' real queries (:func:`perfbench.roofline._probed`,
times the calls). The zero rows that pad each call's tail batch are
scanned too, and count as waste here.

On standard error beside it: the program's ``probes_dropped`` as a share
of the (query row, probe) pairs it was handed, its ``pairs_probed``
against the roofline's count over the same rows (the real queries and the
padding's zero rows), and ``ivf_flat.search.host_reads`` a call."""
import torch

from perfbench import roofline


def _padding(config: dict, nq: int) -> int:
    """Zero rows the library's search adds to a call of ``nq`` queries:
    its tail batch is padded to ``query_batch`` rows when there is more
    than one batch."""
    qb = int(config["query_batch"])
    return (-nq) % qb if nq > qb else 0


def read(trace):
    scanned = trace.histogram("ivf_flat.fused.pairs_scanned")
    c = trace.context
    calls = c.get("calls", 0)
    if scanned is None or not calls:
        return None
    queries, view = c["queries"], c["view"]
    n_probes = c["config"]["search"]["n_probes"]
    real = roofline._probed(view, queries, n_probes)[0] * calls
    pad = _padding(c["config"], queries.shape[0])
    zero = roofline._probed(view, torch.zeros_like(queries[:1]), n_probes)[0]
    handed = real + zero * pad * calls
    rows = (queries.shape[0] + pad) * calls
    trace.notes.append(f"B1 over-scan: {scanned['sum']:.6g} pairs scanned over {real} pairs "
                       f"probed by {queries.shape[0]} queries x {calls} calls")
    probed = trace.histogram("ivf_flat.fused.pairs_probed")
    if probed is not None:
        trace.notes.append(f"B1 pairs_probed: program {probed['sum']:.17g}, roofline {handed} "
                           f"over the same {rows} rows ({pad} zero rows a call), difference "
                           f"{probed['sum'] - handed:.17g} ({(probed['sum'] - handed) / handed:.3e})")
    dropped = trace.histogram("ivf_flat.fused.probes_dropped")
    if dropped is not None:
        trace.notes.append(f"B1 probes_dropped: {dropped['sum']:.17g} of {rows * n_probes} "
                           f"(query row, probe) pairs ({dropped['sum'] / (rows * n_probes):.6e})")
    reads = trace.histogram("ivf_flat.search.host_reads")
    if reads is not None:
        trace.notes.append(f"search host_reads: {reads['sum']:.17g} over {calls} calls "
                           f"({reads['sum'] / calls:.6g} a call)")
    return scanned["sum"] / real
