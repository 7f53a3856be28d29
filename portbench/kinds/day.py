"""A day fitted and scored, one whole day after another.

Set-up draws the day's events on the device from the seed
(`traffic/events.py`), hands the program its corpus as the scoring run
builds it (`CorpusBundle`: tokens in the [src | dst] layout for two
documents an event) and warms every shape with a short fit and a
selection. Each step of the window is one day as `run_scoring` runs it
after its corpus build: `fit_engine(cfg, bundle, "gibbs", device)`
with the workload's chains, then `select_suspicious_events` of the
bottom-M, read back to the host. Each day's fit seed is the run's
seed advanced a day, so the days differ in their draws alone.

The check takes one day of the window, drawn from the seed, and holds
its fitted model against the plain reference's own fit of the same
tokens (`fit_ll_gap`) and its scores and selection against the
reference's float64 scores under the program's model (`score_gap`,
`select_gap`).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import cost, tracing
from portbench.reference import gibbs as ref_gibbs
from portbench.reference import judge
from portbench.reference import score as ref_score
from portbench.traffic.events import make_day


def fit_seed(seed: int, day: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (day + 1)) % (1 << 62)


def _fit_settings(config: dict, traffic: dict) -> dict:
    lda = config["lda"]
    return {"n_topics": lda["n_topics"], "alpha": lda["alpha"],
            "eta": lda["eta"], "n_sweeps": traffic.get("n_sweeps",
                                                       lda["n_sweeps"]),
            "burn_in": traffic.get("burn_in", lda["burn_in"]),
            "block_size": traffic.get("block_size", lda["block_size"]),
            "n_chains": traffic["chains"]}


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.spans = tracing.Spans()
        self.fit = _fit_settings(config, traffic)
        self.tol = config["pipeline"]["tol"]
        self.max_results = traffic["max_results"]
        self.outputs: dict = {}
        self.numbers: dict | None = None

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from onix_torch.config import LDAConfig, OnixConfig
        from onix_torch.corpus import Corpus
        from onix_torch.pipelines.corpus_build import (CorpusBundle,
                                                       Vocabulary)
        self.day = make_day(self.config["day"], self.traffic["events"],
                            self.seed, self.device)
        docs, words = self.day.tokens()
        self.docs, self.words = docs, words
        n = self.day.n_events
        te = np.arange(n, dtype=np.int64)
        if self.day.dst is not None:
            te = np.concatenate([te, te])
        corpus = Corpus(docs.to(torch.int32).cpu().numpy(),
                        words.to(torch.int32).cpu().numpy(),
                        self.day.n_docs, self.day.n_vocab)
        self.bundle = CorpusBundle(
            corpus=corpus, vocab=Vocabulary(np.empty(0, object)),
            doc_keys=np.empty(0, object), token_event=te,
            n_real_tokens=corpus.n_tokens)
        f = self.fit
        self.cfg = OnixConfig()
        self.cfg.lda = LDAConfig(
            n_topics=f["n_topics"], alpha=f["alpha"], eta=f["eta"],
            n_sweeps=f["n_sweeps"], burn_in=f["burn_in"],
            block_size=f["block_size"], n_chains=f["n_chains"], seed=0)
        # Warm every shape: a fit of two sweeps (K1, the likelihood, the
        # estimates) and the day's selection (the table, K2).
        warm = OnixConfig()
        warm.lda = LDAConfig(
            n_topics=f["n_topics"], alpha=f["alpha"], eta=f["eta"],
            n_sweeps=2, burn_in=1, block_size=f["block_size"],
            n_chains=f["n_chains"], seed=fit_seed(self.seed, -2))
        self._day(warm, record=False)
        self.outputs.clear()

    def _day(self, cfg, record=True):
        from onix_torch.pipelines.corpus_build import \
            select_suspicious_events
        from onix_torch.pipelines.run import fit_engine
        sp = self.spans if record else tracing.Spans()
        with sp("fit"):
            fit = fit_engine(cfg, self.bundle, "gibbs", self.device)
        with sp("score"):
            top = select_suspicious_events(
                self.bundle, fit["theta"], fit["phi_wk"],
                self.day.n_events, tol=self.tol,
                max_results=self.max_results, device=self.device)
            scores = top.scores.cpu().numpy()
            idx = top.indices.cpu().numpy()
        return fit["theta"], fit["phi_wk"], scores, idx

    # -- the window --------------------------------------------------------

    def step(self, i: int) -> None:
        self.cfg.lda.seed = fit_seed(self.seed, i)
        with self.spans("step"):
            self.outputs[i] = (self.cfg.lda.seed, *self._day(self.cfg))

    def traced(self) -> tracing.Trace:
        """One more day under the profiler, after the window."""
        i = len(self.outputs)

        def one():
            self.spans.profiling = True
            try:
                self.step(i)
            finally:
                self.spans.profiling = False
        trace = tracing.profile(one, steps=1)
        for name in ("step", "fit", "score"):
            self.spans.times[name].pop()
        self.outputs.pop(i)
        return trace

    def cost(self) -> dict:
        f = self.fit
        n_tok = int(self.docs.shape[0])
        ld = np.bincount(self.bundle.corpus.doc_ids,
                         minlength=self.day.n_docs)
        lw = np.bincount(self.bundle.corpus.word_ids,
                         minlength=self.day.n_vocab)
        fitc = cost.gibbs_fit(ld, lw, n_tok, chains=f["n_chains"],
                              block=f["block_size"], k=f["n_topics"],
                              n_sweeps=f["n_sweeps"])
        sc = cost.score_day(self.day.n_docs, self.day.n_vocab,
                            chains=f["n_chains"], k=f["n_topics"],
                            n_events=self.day.n_events,
                            tokens_per_event=self.day.tokens_per_event,
                            max_results=self.max_results)
        return {"step_bytes": fitc["step_bytes"], "steps": fitc["steps"],
                "fit_bytes": fitc["bytes"], "fit_flops": fitc["flops"],
                "day_bytes": fitc["bytes"] + sc["bytes"],
                "day_flops": fitc["flops"] + sc["flops"]}

    # -- the check ---------------------------------------------------------

    def release(self) -> None:
        """Free what the program holds on the card before the reference
        runs."""
        self.bundle = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        days = sorted(self.outputs)
        rng = np.random.default_rng([self.seed, 2])
        day = days[int(rng.integers(len(days)))]
        seed, theta, phi, scores, idx = self.outputs[day]
        self.numbers = judge_day(self, seed, theta, phi, scores, idx)
        return self.numbers

    def failed(self, limits: dict) -> int:
        return int(any(self.numbers[k] > limits[k] for k in limits))


def judge_day(r: Runner, seed: int, theta, phi, scores, idx) -> dict:
    """The day's numbers: the program's (or a control's) fitted model,
    scores and selection against the plain reference."""
    dev = r.device
    f = r.fit
    th = torch.as_tensor(theta, device=dev)
    ph = torch.as_tensor(phi, device=dev)
    ref_th, ref_ph = ref_gibbs.fit(
        r.docs, r.words, r.day.n_docs, r.day.n_vocab,
        n_topics=f["n_topics"], alpha=f["alpha"], eta=f["eta"],
        n_sweeps=f["n_sweeps"], burn_in=f["burn_in"],
        block_size=f["block_size"], n_chains=f["n_chains"], seed=seed)
    out = judge.fit_gap(
        ref_score.log_likelihood(th, ph, r.docs, r.words),
        ref_score.log_likelihood(ref_th, ref_ph, r.docs, r.words))
    del ref_th, ref_ph
    table = ref_score.table(th, ph)
    ev = ref_score.event_scores(table, r.day.src, r.day.dst, r.day.word)
    del table
    out.update(judge.selection(scores, idx, ev, tol=r.tol,
                               max_results=r.max_results))
    return out


def control(r: Runner, seed: int) -> dict:
    """The reference in the program's place, a precision lower: its fit
    with the conditional in bfloat16, its table from TF32 inputs, its
    scores and selection in float32; judged as the program is."""
    f = r.fit
    th, ph = ref_gibbs.fit(
        r.docs, r.words, r.day.n_docs, r.day.n_vocab,
        n_topics=f["n_topics"], alpha=f["alpha"], eta=f["eta"],
        n_sweeps=f["n_sweeps"], burn_in=f["burn_in"],
        block_size=f["block_size"], n_chains=f["n_chains"],
        seed=seed ^ 0xC0, precision="bf16")
    th, ph = th.float(), ph.float()
    table = ref_score.table(th, ph, precision="tf32")
    ev = ref_score.event_scores(table, r.day.src, r.day.dst, r.day.word)
    s, i = ref_score.bottom(ev, r.tol, r.max_results)
    return judge_day(r, seed, th.cpu().numpy(), ph.cpu().numpy(), s, i)


def end_to_end(r: Runner, walls: list, window_s: float) -> dict:
    return {"day_events_per_s": r.day.n_events * len(walls) / window_s}
