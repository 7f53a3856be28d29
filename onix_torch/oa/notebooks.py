"""Analyst scoring-notebook templates — the reference's `ipynb/` dir.

The reference closes its feedback loop through per-datatype IPython
notebooks served next to the dashboards (SURVEY.md §2.1 #14: "In-
dashboard notebooks (edge/threat investigation) where the analyst labels
results"; reference README.md:48,55). onix ships the same artifact:
generated `.ipynb` templates that load the day's enriched results,
summarize the top suspects, and write labels through
`onix_torch.oa.feedback.append_feedback` — the identical CSV contract the
dashboard's Save button and `onix label` use, so all three label paths
converge on one noise-filter input.

`onix setup` installs the templates under `<oa.data_dir>/notebooks/`,
which `onix serve` exposes at `/data/notebooks/` for download into any
Jupyter instance.

The port's own copy of `onix/oa/notebooks.py`. The one difference is
deliberate: the template's import cell names `onix_torch.config`,
`onix_torch.oa.engine` and `onix_torch.oa.feedback`, so a hosted
notebook runs the port and never the JAX package. Every other byte of a
written `.ipynb` equals the reference's. It imports no torch.
"""

from __future__ import annotations

import json
import pathlib

DATATYPES = ("flow", "dns", "proxy")

_CELLS = [
    ("markdown", """# onix — {datatype} threat investigation

Score a day of surfaced **{datatype}** suspicious connects and feed your
labels back to the model. Labels: `1` high threat, `2` medium, `3`
benign — only *benign* labels bias the next run (duplicating a
confirmed threat would teach the model to stop surfacing it)."""),
    ("code", """import os
import pandas as pd

from onix_torch.config import load_config
from onix_torch.oa.engine import oa_dir
from onix_torch.oa.feedback import append_feedback

DATATYPE = "{datatype}"
DATE = os.environ.get("ONIX_DATE", "2016-07-08")
cfg = load_config(os.environ.get("ONIX_CONFIG") or None)

day = oa_dir(cfg, DATATYPE, DATE)
results = pd.read_csv(day / "suspicious.csv")
print(f"{{len(results)}} suspicious {datatype} events for {{DATE}}")"""),
    ("code", """# The most suspicious events, with enrichment columns.
results.head(20)"""),
    ("code", """# Label by dashboard rank, then run this cell to save.
# Example: ranks 3 and 7 are benign, rank 1 is a confirmed threat.
labels = {{
    # rank: label,
    # 3: 3,
    # 7: 3,
    # 1: 1,
}}

if labels:
    rows = results[results["rank"].isin(labels)].copy()
    rows["label"] = rows["rank"].map(labels)
    path = append_feedback(cfg, DATATYPE, DATE,
                           rows[["ip", "word", "rank", "score", "label"]])
    print(f"wrote {{len(rows)}} labels -> {{path}}")
else:
    print("no labels staged")"""),
]


def _notebook(datatype: str) -> dict:
    cells = []
    for i, (kind, src) in enumerate(_CELLS):
        text = src.format(datatype=datatype)
        cells.append({
            "cell_type": kind,
            "id": f"onix-{datatype}-{i}",   # required from nbformat 4.5
            "metadata": {},
            "source": text.splitlines(keepends=True),
            **({"outputs": [], "execution_count": None}
               if kind == "code" else {}),
        })
    return {
        "nbformat": 4,
        "nbformat_minor": 5,
        "metadata": {
            "kernelspec": {"name": "python3", "display_name": "Python 3",
                           "language": "python"},
            "language_info": {"name": "python"},
        },
        "cells": cells,
    }


def write_notebooks(dest_dir: str | pathlib.Path) -> list[pathlib.Path]:
    """Materialize the per-datatype templates; returns written paths."""
    dest = pathlib.Path(dest_dir)
    dest.mkdir(parents=True, exist_ok=True)
    out = []
    for t in DATATYPES:
        path = dest / f"{t}_threat_investigation.ipynb"
        path.write_text(json.dumps(_notebook(t), indent=1))
        out.append(path)
    return out


def code_cells(path: str | pathlib.Path) -> list[str]:
    """The notebook's code-cell sources (for tests and headless use)."""
    nb = json.loads(pathlib.Path(path).read_text())
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


# -- hosted notebooks ------------------------------------------------------
#
# The reference HOSTS live notebooks next to the dashboards (its UI is
# served from an IPython file server). onix goes one step further than
# file serving: `onix serve` renders any installed template as HTML at
# /notebooks/<datatype>.html and EXECUTES it against the current OA
# data dir on POST /notebooks/run — the analyst sees live outputs in
# the dashboard without a separate Jupyter deployment (the .ipynb
# download for a full Jupyter session still works).

def render_html(path: str | pathlib.Path, executed_nb=None) -> str:
    """Standalone HTML for a notebook: the template as-is, or an
    in-memory executed NotebookNode when `executed_nb` is given."""
    import nbformat
    from nbconvert import HTMLExporter

    nb = (executed_nb if executed_nb is not None
          else nbformat.read(str(path), as_version=4))
    body, _resources = HTMLExporter().from_notebook_node(nb)
    return body


def execute_to_html(path: str | pathlib.Path, *, date: str,
                    config_path: str | None = None,
                    timeout: int = 180) -> str:
    """Run the notebook headless (fresh python3 kernel) against the
    current config/date and render the result, tracebacks included
    (`allow_errors` — an analyst must SEE a broken cell, not get a 500).

    The kernel is a new interpreter: it inherits this process's env but
    not its sys.path or config object, so a parameter cell is injected
    that pins both (same contract the template reads via ONIX_DATE /
    ONIX_CONFIG)."""
    import nbformat
    from nbclient import NotebookClient

    nb = nbformat.read(str(path), as_version=4)
    repo_root = str(pathlib.Path(__file__).resolve().parents[2])
    lines = [
        "import os, sys",
        f"sys.path.insert(0, {repo_root!r})",
        f"os.environ['ONIX_DATE'] = {date!r}",
    ]
    if config_path:
        lines.append(f"os.environ['ONIX_CONFIG'] = {str(config_path)!r}")
    nb.cells.insert(0, nbformat.v4.new_code_cell(
        "\n".join(lines), metadata={"tags": ["injected-parameters"]}))
    NotebookClient(nb, timeout=timeout, kernel_name="python3",
                   allow_errors=True).execute()
    return render_html(path, executed_nb=nb)
