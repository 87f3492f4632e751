"""K1, the sorted-segment reduce and compact (csrc/sseg.cu): 36 bytes an
entry (a 4-byte segment flag and eight 4-byte value lanes read once) and
32 bytes a record written (eight lanes).  The record count depends on
the data: it is read from the launch's own count after it."""

from portbench.roofline.peaks import bound

ENTRY = "sseg_reduce_compact"     # the C entry point of the program's library
KERNEL = "sseg_onepass"           # the device kernel it launches


def on_launch(args, device_copy) -> dict:
    # seg_new, v8, N, ops, out_budget, out, count, scratch, stream
    return {"N": int(args[2]), "out_budget": int(args[4]),
            "count": device_copy(args[6], 1)}


def bound_s(rec: dict) -> tuple[float, str]:
    count = rec["count"]
    count = int(count[0] if isinstance(count, list) else count)
    return bound(36 * rec["N"] + 32 * min(count, rec["out_budget"]))
