"""Faults planted in the timed path underneath a run, to show that the
check of `correct` catches them: `plant(name)` patches the program in
this process and returns the function that undoes it. The benchmark's
own runs never plant one; `readings.py --fault` and the tests do.

- `unchanged_step`: every Gibbs block step returns its state unchanged.
- `half_scan_day`, `half_scan_rescore`: the day's selection (the pair
  scan or the single-token one), or a request's filtered scan, sees
  only the first half of the events.
- `altered_day`, `altered_rescore`: the first index of each answer is
  replaced, where it is produced, by an event it did not hold.
- `unchanged_filter`: a submission's verdicts are dropped, the day's
  accumulated filter served unchanged.

One card a cell: there is no exchange between cards to leave out.
"""

from __future__ import annotations


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


def _altered(module, name):
    real = getattr(module, name)

    def alter(*a, **k):
        top = real(*a, **k)
        idx = top.indices.clone()
        taken = set(idx.tolist())
        idx[0] = next(j for j in range(1 << 40) if j not in taken)
        return type(top)(top.scores, idx)
    return _patch(module, name, alter)


def unchanged_step():
    from onix_torch.models import lda_gibbs
    return _patch(lda_gibbs, "block_step", lambda *a, **k: None)


def _both(undos):
    def undo():
        for u in undos:
            u()
    return undo


def half_scan_day():
    from onix_torch.models import scoring
    pair, single = scoring.table_pair_bottom_k_fast, \
        scoring.table_bottom_k_fast

    def half_pair(table, src, dst, *a, **k):
        n = src.shape[0] // 2
        return pair(table, src[:n], dst[:n], *a, **k)

    def half_single(table, idx, *a, **k):
        return single(table, idx[:idx.shape[0] // 2], *a, **k)
    return _both([_patch(scoring, "table_pair_bottom_k_fast", half_pair),
                  _patch(scoring, "table_bottom_k_fast", half_single)])


def altered_day():
    from onix_torch.models import scoring
    return _both([_altered(scoring, "table_pair_bottom_k_fast"),
                  _altered(scoring, "table_bottom_k_fast")])


def unchanged_filter():
    from onix_torch.feedback.filter import HostFilter
    real = HostFilter.merged

    def merged(self, **k):
        # The accumulated filter is merged into an empty one at set-up;
        # a submission's verdicts are the ones dropped.
        return real(self, **k) if self.empty_filter else self
    return _patch(HostFilter, "merged", merged)


def half_scan_rescore():
    from onix_torch.feedback import rescore
    real = rescore.table_pair_bottom_k_filtered_fast

    def half(table, src, dst, word, hi, lo, *a, **k):
        n = src.shape[0] // 2
        return real(table, src[:n], dst[:n], word[:n], hi[:n], lo[:n],
                    *a, **k)
    return _patch(rescore, "table_pair_bottom_k_filtered_fast", half)


def altered_rescore():
    from onix_torch.feedback import rescore
    return _altered(rescore, "table_pair_bottom_k_filtered_fast")


FAULTS = {f.__name__: f for f in (
    unchanged_step, half_scan_day, altered_day, unchanged_filter,
    half_scan_rescore, altered_rescore)}
DAY = ("unchanged_step", "half_scan_day", "altered_day")
RESCORE = ("unchanged_filter", "half_scan_rescore", "altered_rescore")


def plant(name: str):
    """Plant the named fault; returns its undo."""
    return FAULTS[name]()
