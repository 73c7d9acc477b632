"""Faults planted in the port underneath a run, for the tests that see
the check come out false. Each patches module attributes for the rest of
the process (the tests undo them through monkeypatch, or run them in a
process of their own)."""

import torch


def search_state_unchanged(mp):
    """Every weight step returns the weights and momentum it was given."""
    from tfnas_tpu_torch.train_search import Search
    orig = Search.weight_step

    def stuck(self, x, y, draws):
        p, mom = self.params, self.mom
        m = orig(self, x, y, draws)
        self.params, self.mom = p, mom
        return m
    mp.setattr(Search, "weight_step", stuck)


def search_half_batch(mp):
    """Every step sees the first half of its batch."""
    from tfnas_tpu_torch.train_search import Search
    for name in ("weight_step", "arch_step"):
        orig = getattr(Search, name)

        def half(self, x, y, draws, orig=orig):
            return orig(self, x[:len(y) // 2], y[:len(y) // 2], draws)
        mp.setattr(Search, name, half)


def search_alphas_unchanged(mp):
    """Every arch step leaves log_alphas as it found them; the betas and
    the optimiser's state move."""
    from tfnas_tpu_torch.train_search import Search
    orig = Search.arch_step

    def stuck(self, x, y, draws):
        kept = self.arch_params["log_alphas"].clone()
        m = orig(self, x, y, draws)
        self.arch_params = dict(self.arch_params, log_alphas=kept)
        return m
    mp.setattr(Search, "arch_step", stuck)


def retrain_state_unchanged(mp):
    from tfnas_tpu_torch.parallel import train_dp
    mp.setattr(train_dp, "sgd_momentum_update",
               lambda params, grads, mom, masks, **kw: (params, mom))


def retrain_half_batch(mp):
    from tfnas_tpu_torch.parallel import train_dp
    orig = train_dp.cross_entropy_label_smooth

    def half(logits, y, n, eps):
        h = y.shape[0] // 2
        return orig(logits[:h], y[:h], n, eps)
    mp.setattr(train_dp, "cross_entropy_label_smooth", half)


def pixels_altered(mp):
    """The loader's first image of every batch inverted."""
    from tfnas_tpu_torch.data.imagelist import ImageList
    orig = ImageList.get_batch

    def altered(self, indices, rng):
        xs, ys = orig(self, indices, rng)
        xs[0] = 255 - xs[0]
        return xs, ys
    mp.setattr(ImageList, "get_batch", altered)


def _patch_served(mp, change):
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    orig = EvalNetwork.apply

    def apply(self, params, state, x, **kw):
        logits, st = orig(self, params, state, x, **kw)
        return change(logits), st
    mp.setattr(EvalNetwork, "apply", apply)


def logit_altered(mp):
    """One class's logit of every served row moved by 3 of its row's
    standard deviations."""
    def change(logits):
        logits = logits.clone()
        logits[:, 0] += 3.0 * logits.float().std(dim=1).to(logits.dtype)
        return logits
    _patch_served(mp, change)


def served_half_batch(mp):
    """The second half of every request's rows left out (zeros)."""
    def change(logits):
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = torch.zeros((), dtype=logits.dtype)
        return logits
    _patch_served(mp, change)
