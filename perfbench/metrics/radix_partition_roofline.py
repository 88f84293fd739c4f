"""Kernel layer (kernels/radix_partition): the share of its roofline the
kernel reached in the traced sub-window, in %.  Each call (one
``radix_rank_*`` launch after its ``radix_hist_*`` launch) needs the
destinations of a rank's valid rows: 4 bytes read and 4 written a row, and
the counts of the ranks plus one bucket for invalid rows
(``counts.radix_partition_bytes``), at 3.35 TB/s.  The time is the device
time of the calls' launches wholly inside the sub-window.  Moves
``rows_per_s``."""


def read(ctx):
    w = ctx.get("device_window")
    if w is None:
        return None
    ks = w.matching("radix_hist", "radix_rank")
    calls = sum(1 for k in ks if "radix_rank" in k[0])
    t = sum(e - s for _, s, e in ks) / 1e9
    if not calls or t <= 0:
        return None
    c = ctx["counts"]
    need = c.radix_partition_bytes(ctx["valid_rows_per_rank"],
                                   ctx["cfg"]["ranks"] + 1)
    return 100.0 * calls * need / c.H100_HBM_BYTES_PER_S / t
