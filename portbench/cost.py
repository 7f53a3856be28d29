"""The yardstick's peaks and the least work of each measured layer,
counted from shapes. Nothing here reads the program's own counts.

Bytes count each input byte read once and each output byte written
once; where the work depends on the data, what these inputs need (the
count rows a block of tokens touches). The least time of a piece of
work is the larger of its bytes over the peak bandwidth and its
operations over the peak float32 rate (the work is float32 outside
the tensor cores).
"""

from __future__ import annotations

import numpy as np

# NVIDIA's data sheet, H100 SXM at 700 W: HBM3 bandwidth and float32
# outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops": 67e12},
}


def least_seconds(device_name: str, n_bytes: float,
                  flops: float = 0.0) -> float | None:
    """The least time of the work on the named card, None for a card
    without a row."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    return max(n_bytes / peak["bytes_per_s"], flops / peak["flops"])


def expected_rows_touched(lengths: np.ndarray, n_tokens: int,
                          block: int) -> float:
    """Expected count of distinct rows (documents or words) among
    `block` tokens drawn at random from `n_tokens`, a row owning
    `lengths[r]` of them."""
    share = np.asarray(lengths, np.float64) / max(n_tokens, 1)
    return float(np.sum(1.0 - np.power(1.0 - share, block)))


def gibbs_block_bytes(chains: int, block: int, k: int, docs_touched: float,
                      words_touched: float) -> float:
    """Least bytes of one blocked Gibbs step over `block` tokens and
    `chains` chains, without the random numbers: the token's doc and
    word ids (int32), each chain's old topic read and new topic written
    (int32), the touched rows of n_dk and n_wk and all of n_k read and
    written (int32)."""
    tokens = block * (4 + 4) + chains * block * 4 * 2
    rows = chains * (docs_touched + words_touched + 1) * k * 4 * 2
    return float(tokens + rows)


def gibbs_block_flops(chains: int, block: int, k: int) -> float:
    """Operations of the step's conditional: per token, chain and topic
    three subtractions of the own count, three additions of the priors,
    a product, a quotient, a logarithm, the noise's addition and the
    comparison of the argmax."""
    return float(chains * block * k * 11)


def gibbs_fit(lengths_doc: np.ndarray, lengths_word: np.ndarray,
              n_tokens: int, *, chains: int, block: int, k: int,
              n_sweeps: int) -> dict:
    """Least bytes and operations of a whole fit's block steps, and the
    count of steps."""
    n_full, rest = divmod(n_tokens, block)
    total_b = total_f = 0.0
    for size, count in ((block, n_full), (rest, 1 if rest else 0)):
        if not count:
            continue
        ud = expected_rows_touched(lengths_doc, n_tokens, size)
        uw = expected_rows_touched(lengths_word, n_tokens, size)
        total_b += count * gibbs_block_bytes(chains, size, k, ud, uw)
        total_f += count * gibbs_block_flops(chains, size, k)
    steps = (n_full + (1 if rest else 0))
    return {"steps": steps * n_sweeps, "bytes": total_b * n_sweeps,
            "flops": total_f * n_sweeps,
            "step_bytes": total_b / steps}


def score_day(n_docs: int, n_vocab: int, *, chains: int, k: int,
              n_events: int, tokens_per_event: int,
              max_results: int) -> dict:
    """Least bytes and operations of scoring a day and selecting its
    bottom-M: θ and φ read, the chain-combined [D, V] table written
    (its products, and a logarithm each and an exponential for several
    chains), every token's table index read and its value gathered
    once, the selection written."""
    table_b = chains * (n_docs + n_vocab) * k * 4 + n_docs * n_vocab * 4
    table_f = chains * n_docs * n_vocab * 2 * k
    if chains > 1:
        table_f += (chains + 1) * n_docs * n_vocab
    tokens = n_events * tokens_per_event
    scan_b = tokens * (4 + 4) + max_results * 8
    return {"bytes": float(table_b + scan_b), "flops": float(table_f)}


def filtered_scan(n_events: int, max_results: int, filter_keys: int) -> dict:
    """Least bytes of one filtered flow scan: each event's two table
    indices, its word key and its pair key halves read once (int32),
    each of its two table values gathered once (float32), the filter
    tables read (two int32 halves a key) and the selection written
    (a float32 score and an int32 index each)."""
    return {"bytes": float(n_events * (4 * 5 + 4 * 2) + filter_keys * 8
                           + max_results * 8),
            "flops": float(n_events * 2)}
