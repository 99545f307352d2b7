"""Faults planted under the timed path, for ``test_faults.py``: each is
a module-level function that the harness runs in every process of the
program before it is built."""


def unchanged_step():
    """A TRAIN step that returns its state unchanged: Adam's step does
    nothing."""
    import torch
    torch.optim.Adam.step = lambda self, closure=None: None


def half_batch():
    """Half of each batch left out, the mean taken over the rest."""
    from shadow_gnn_torch.parallel import partition
    from shadow_gnn_torch.train import pipeline
    orig, orig_spmd = pipeline.weighted_loss_fn, partition.spmd_weighted_loss

    def half(w):
        w = w.clone()
        w[: w.shape[0] // 2] = 0.0
        return w

    pipeline.weighted_loss_fn = lambda cfg, lg, lab, w: orig(cfg, lg, lab, half(w))
    partition.spmd_weighted_loss = lambda cfg, lg, lab, w: orig_spmd(cfg, lg, lab, half(w))


def stale_epoch():
    """Every epoch after the first replays the first epoch's batches
    (its permutation left in place, as a stale static buffer would);
    the first epoch, and the profile pass before it, are sound."""
    from shadow_gnn_torch.train.pipeline import Trainer
    orig = Trainer._epoch_arrays
    seen = []

    def stale(self, mode, ordered=False):
        out = orig(self, mode, ordered)
        seen.append(out)
        return seen[1] if len(seen) > 2 else out
    Trainer._epoch_arrays = stale


def no_exchange():
    """The gradients' all-reduce between the ranks left out, and with it
    the program's own check that the ranks' parameters agree, so that
    the harness's judgement is what catches it."""
    from shadow_gnn_torch.parallel import partition
    from shadow_gnn_torch.train.pipeline import Trainer
    partition.all_reduce_grads = lambda params: None
    Trainer.check_replicas = lambda self: None


def altered_answer():
    """An answer altered where it is produced: each batch's first
    probability row shifted."""
    from shadow_gnn_torch.train import pipeline
    orig = pipeline.predict_fn

    def alter(cfg, logits):
        p = orig(cfg, logits)
        return p.index_add(0, p.new_zeros(1, dtype=p.new_empty(0).long().dtype),
                           p.new_full((1, p.shape[1]), 1e-3))
    pipeline.predict_fn = alter
