"""unpadded_share.train_dcn: the live share of the items that the traced
window's lookups gathered, from the program's counters ``lookup.items``
and ``lookup.pad_items`` (counted per graph replay), in %. The counters
and not the spans: the model's spans do not run on a replay."""


def read(run):
    c = run.get("counters")
    if run.get("bench_mode") != "train_dcn" or c is None:
        return None
    items, pad = c.get("lookup.items", 0), c.get("lookup.pad_items", 0)
    if items + pad <= 0:
        return None
    return 100 * items / (items + pad)
