"""What the port's tools share: the ``--device`` flag, DNSMOS's device
index, and the CSV writer that stands in for the JAX tools' pandas."""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Dict, List, Sequence

import torch


def add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")


def onnx_device(dev: torch.device) -> int:
    """DNSMOS's device: the card's index, or -1 for the CPU."""
    return -1 if dev.type != "cuda" else (dev.index or 0)


def columns_of(rows: Sequence[Dict]) -> List[str]:
    """Every key of the rows in order of first appearance (a DataFrame's
    columns)."""
    cols: Dict[str, None] = {}
    for row in rows:
        cols.update(dict.fromkeys(row))
    return list(cols)


def _cell(v) -> object:
    # numpy scalars print as np.float64(...) under csv's repr of floats
    if isinstance(v, float):
        return float(v)
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        return v.item()
    return v


def write_csv(rows: Sequence[Dict], path) -> List[str]:
    """The rows as a CSV with a header, the columns and cells as
    ``pandas.DataFrame(rows).to_csv(path, index=False)`` writes them."""
    cols = columns_of(rows)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for row in rows:
            w.writerow(["" if row.get(c) is None else _cell(row[c]) for c in cols])
    return cols


def numeric_means(rows: Sequence[Dict]) -> Dict[str, float]:
    """The mean of each column whose cells are all numbers (``DataFrame.mean(
    numeric_only=True)``)."""
    out = {}
    for c in columns_of(rows):
        vals = [r.get(c) for r in rows]
        if all(isinstance(_cell(v), (int, float)) and not isinstance(v, str) for v in vals):
            out[c] = sum(float(v) for v in vals) / len(vals)
    return out


def markdown_row(values: Dict[str, float]) -> str:
    """A one-row markdown table of ``values``."""
    head = "| " + " | ".join(values) + " |"
    sep = "|" + "|".join("---:" for _ in values) + "|"
    return "\n".join([head, sep, "| " + " | ".join(f"{v:g}" for v in values.values()) + " |"])
