"""An analyst's feedback loop on a scored day resident on the card.

Set-up draws the day's events on the device from the seed, a
one-chain model of the day (`served_model`, the model bank's rule:
served models are one chain) and its score table (the program's
`score_table`), and the day's accumulated filter: pair and word keys
drawn from the least probable events. Then a pool of distinct
analysts' submissions, each a few new verdicts on events of the day's
current bottom-M under that filter.

Closed loop, one request outstanding: each step is one submission.
The program merges its verdicts into the accumulated filter
(`HostFilter.merged`) and puts the tables on the card (`filter` span),
then rescores the whole day with the filtered scan
(`table_pair_bottom_k_filtered_fast`) and reads the bottom-M back
(`scan` span).

The check takes a sample of the window's requests, drawn from the
seed, and holds each answer against the reference's own merge, its
float64 scores and its selection.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import cost, tracing
from portbench.reference import judge
from portbench.reference import score as ref_score
from portbench.traffic.events import make_day, served_model

BOOST_SCALE = 0.25


def _pick(rng, keys: np.ndarray, n: int) -> np.ndarray:
    keys = np.unique(keys)
    return rng.choice(keys, size=min(n, keys.size), replace=False)


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.spans = tracing.Spans()
        self.tol = config["pipeline"]["tol"]
        self.max_results = traffic["max_results"]
        self.outputs: dict = {}
        self.numbers: dict | None = None

    def setup(self) -> None:
        from onix_torch.feedback.filter import HostFilter
        from onix_torch.models.scoring import score_table
        dev = self.device
        day = make_day(self.config["day"], self.traffic["events"],
                       self.seed, dev)
        if day.dst is None:
            raise ValueError("the rescore kind scans [src | dst] pairs")
        self.day = day
        self.theta, self.phi = served_model(
            day, self.config["lda"]["n_topics"], self.seed)
        v = day.n_vocab
        self.pair_key = day.src * (1 << 32) + day.dst
        self.table = score_table(self.theta, self.phi).reshape(-1)
        self.idx_src = (day.src * v + day.word).to(torch.int32)
        self.idx_dst = (day.dst * v + day.word).to(torch.int32)
        self.word_ids = day.word.to(torch.int32)
        self.pair_hi = day.src.to(torch.int32)
        self.pair_lo = day.dst.to(torch.int32)
        self._make_requests()
        self.base = HostFilter.empty(BOOST_SCALE).merged(
            **{k: v.astype(np.uint64) for k, v in self.base_keys.items()})
        for i in range(3):
            self._request(i, record=False)

    def _bottom_events(self, filt: dict | None, n: int) -> torch.Tensor:
        """The benchmark's own ranking of the day under a filter: the n
        least probable events (float32 scores from the f32 table)."""
        s = torch.minimum(self.table[self.idx_src.long()],
                          self.table[self.idx_dst.long()])
        if filt is not None:
            s = ref_score.apply_filter(s, self.day.word, self.pair_key,
                                       filt, BOOST_SCALE)
        return torch.topk(s, n, largest=False).indices

    def _make_requests(self) -> None:
        t = self.traffic
        rng = np.random.default_rng([self.seed, 3])
        fl = t["filter"]
        pool = self._bottom_events(None, fl["pool"])
        pairs = _pick(rng, self.pair_key[pool].cpu().numpy(), fl["pairs"])
        words = _pick(rng, self.day.word[pool].cpu().numpy(), fl["words"])
        nb_p = int(round(pairs.size * fl["boost_share"]))
        nb_w = int(round(words.size * fl["boost_share"]))
        self.base_keys = {"pair_boost": pairs[:nb_p],
                          "pair_suppress": pairs[nb_p:],
                          "word_boost": words[:nb_w],
                          "word_suppress": words[nb_w:]}
        top = self._bottom_events(self.base_keys, self.max_results)
        top_pairs = self.pair_key[top].cpu().numpy()
        top_words = self.day.word[top].cpu().numpy()
        rq = t["request"]
        self.requests = []
        for _ in range(rq["distinct"]):
            p = _pick(rng, top_pairs, rq["pair_suppress"] + rq["pair_boost"])
            self.requests.append({
                "pair_suppress": p[:rq["pair_suppress"]],
                "pair_boost": p[rq["pair_suppress"]:],
                "word_suppress": _pick(rng, top_words,
                                       rq["word_suppress"])})

    def _request(self, i: int, record: bool = True):
        from onix_torch.feedback.rescore import \
            table_pair_bottom_k_filtered_fast
        req = self.requests[i % len(self.requests)]
        sp = self.spans if record else tracing.Spans()
        with sp("filter"):
            filt = self.base.merged(
                **{k: v.astype(np.uint64) for k, v in req.items()})
            tables = filt.tables(device=self.device)
        with sp("scan"):
            top = table_pair_bottom_k_filtered_fast(
                self.table, self.idx_src, self.idx_dst, self.word_ids,
                self.pair_hi, self.pair_lo, tables, tol=self.tol,
                max_results=self.max_results)
            scores = top.scores.cpu().numpy()
            idx = top.indices.cpu().numpy()
        return scores, idx

    def step(self, i: int) -> None:
        with self.spans("step"):
            self.outputs[i] = self._request(i)

    def traced(self) -> tracing.Trace:
        n = self.traffic["traced_requests"]
        start = len(self.outputs)

        def run():
            self.spans.profiling = True
            try:
                for i in range(start, start + n):
                    self.step(i)
            finally:
                self.spans.profiling = False
        trace = tracing.profile(run, steps=n)
        for name in ("step", "filter", "scan"):
            del self.spans.times[name][-n:]
        for i in range(start, start + n):
            self.outputs.pop(i)
        return trace

    def cost(self) -> dict:
        keys = sum(v.size for v in self.base_keys.values()) + sum(
            v.size for v in self.requests[0].values())
        c = cost.filtered_scan(self.day.n_events, self.max_results, keys)
        return {"request_bytes": c["bytes"], "request_flops": c["flops"]}

    def release(self) -> None:
        self.table = self.idx_src = self.idx_dst = None
        self.word_ids = self.pair_hi = self.pair_lo = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        rng = np.random.default_rng([self.seed, 4])
        steps = sorted(self.outputs)
        n = min(self.traffic["checked_requests"], len(steps))
        picked = [steps[j] for j in sorted(rng.choice(len(steps), n,
                                                       replace=False))]
        table = ref_score.table(self.theta, self.phi)
        ev = ref_score.event_scores(table, self.day.src, self.day.dst,
                                    self.day.word)
        del table
        readings = []
        for i in picked:
            req = self.requests[i % len(self.requests)]
            filt = ref_score.merge_filter(self.base_keys, req)
            s = ref_score.apply_filter(ev, self.day.word, self.pair_key,
                                       filt, BOOST_SCALE)
            scores, idx = self.outputs[i]
            readings.append(judge.selection(
                scores, idx, s, tol=self.tol, max_results=self.max_results))
        self.readings = readings
        self.numbers = judge.worst(readings)
        return self.numbers

    def failed(self, limits: dict) -> int:
        return sum(any(r[k] > limits[k] for k in limits)
                   for r in self.readings)


def control(r: Runner, i: int) -> dict:
    """The reference in the program's place for request `i`, a
    precision lower: its own merge, its scan over the table's values
    in bfloat16; judged as the program is."""
    req = r.requests[i % len(r.requests)]
    filt = ref_score.merge_filter(r.base_keys, req)
    table = ref_score.table(r.theta, r.phi).to(torch.bfloat16)
    ev = ref_score.event_scores(table, r.day.src, r.day.dst, r.day.word)
    s = ref_score.apply_filter(ev, r.day.word, r.pair_key, filt,
                               BOOST_SCALE).float()
    scores, idx = ref_score.bottom(s, r.tol, r.max_results)
    table = ref_score.table(r.theta, r.phi)
    ev = ref_score.event_scores(table, r.day.src, r.day.dst, r.day.word)
    ref = ref_score.apply_filter(ev, r.day.word, r.pair_key, filt,
                                 BOOST_SCALE)
    return judge.selection(scores, idx, ref, tol=r.tol,
                           max_results=r.max_results)


def end_to_end(r: Runner, walls: list, window_s: float) -> dict:
    lat = sorted(walls)
    p95 = float(np.percentile(np.asarray(lat) * 1e3, 95))
    return {"rescore_events_per_s": r.day.n_events * len(walls) / window_s,
            "rescore_p95_ms": p95}
