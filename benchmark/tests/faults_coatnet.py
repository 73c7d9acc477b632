"""Faults planted in the port's relative-position bias underneath a run of
the CoAtNet retrain cell, for the tests that see its check come out
false (in the manner of faults.py: each patches a module attribute for
the rest of the process, undone through monkeypatch)."""


def _patch_bias(mp, change):
    from tfnas_tpu_torch.ops import attention
    orig = attention.rel_bias
    mp.setattr(attention, "rel_bias",
               lambda table, h, w: change(orig(table, h, w)))


def bias_left_out(mp):
    """The bias never reaches the logits (its tables get no gradient)."""
    _patch_bias(mp, lambda b: b * 0.0)


def bias_transposed(mp):
    """The bias of offset j - i added where i - j's belongs."""
    _patch_bias(mp, lambda b: b.transpose(-1, -2))
