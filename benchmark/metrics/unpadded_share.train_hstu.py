"""unpadded_share.train_hstu: the live share of the attention scores that
the traced window's steps computed, from the program's device counters
``hstu.live_scores`` (each layer's and head's causal scores of the
histories) and ``hstu.pad_scores`` (the rest of what the tiled attention
computed: masked slots of other histories and the blocks' triangles),
counted per graph replay from each replay's own batch, in %. None where
the program counts neither (a program without HSTU)."""


def read(run):
    c = run.get("counters")
    if run.get("bench_mode") != "train_hstu" or c is None:
        return None
    live, pad = c.get("hstu.live_scores", 0), c.get("hstu.pad_scores", 0)
    if live + pad <= 0:
        return None
    return 100 * live / (live + pad)
