"""One general generator for every traffic mix: a mix is a JSON file of
parameters under ``portbench/traffic/``.

Training mixes give ``batch``, ``seq`` and ``records``: the benchmark
writes ``records`` rows of ``seq + 1`` token ids, uniform over the
vocabulary, to a RecordIO shard, and the program reads it.

Serving mixes give log-uniform ``prompt_tokens`` and ``output_tokens``
ranges and Poisson arrivals at the cell's ``rate_per_s``.  Every seed
gets the same multiset of lengths and of gaps between arrivals, in
another order: the values are the distributions' quantiles at
``(i + 0.5) / n``, permuted by the seed, so seeds change which request
is long and when it comes, not how much work a window holds.  The
schedule has three segments: a pre-roll before the window (so the
window opens on a loaded system), the window, and arrivals after it
that keep the load on while the window's requests finish.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import List

import torch

_MASK = (1 << 63) - 1
RECORDIO_MAGIC = 0xCED7230A


def _gen(seed: int, salt: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed((int(seed) * 6_364_136_223 + 1_442_695_041 * salt) & _MASK)
    return g


# -- training ---------------------------------------------------------------

def train_tokens(traffic: dict, vocab: int, seed: int) -> torch.Tensor:
    """``[records, seq + 1]`` int32 token ids from the seed."""
    return torch.randint(0, vocab, (traffic["records"], traffic["seq"] + 1),
                         generator=_gen(seed, 1), dtype=torch.int32)


def train_batch(tokens: torch.Tensor, traffic: dict, step: int):
    """``(ids, labels)`` of the ``step``-th batch (from 0) as the feed
    delivers them on one partition: records in file order."""
    b = traffic["batch"]
    rows = tokens[step * b:(step + 1) * b].long()
    return rows[:, :-1], rows[:, 1:]


def write_recordio(path: str, tokens: torch.Tensor) -> None:
    """Each row as one RecordIO record (dmlc-core's format: the magic
    word, a length word whose top 3 bits are the continuation flag, the
    payload padded to 4 bytes).  Token ids below 2**31 never equal the
    magic word, so no record needs splitting."""
    data = tokens.numpy()
    if data.size and int(data.max()) >= RECORDIO_MAGIC:
        raise ValueError("a token id equals the RecordIO magic word")
    head = struct.Struct("<II")
    with open(path, "wb") as f:
        for row in data:
            payload = row.astype("<i4").tobytes()
            if len(payload) >= 1 << 29:
                raise ValueError("record too long for RecordIO")
            f.write(head.pack(RECORDIO_MAGIC, len(payload)))
            f.write(payload)
            f.write(b"\0" * (-len(payload) % 4))


# -- serving ----------------------------------------------------------------

@dataclasses.dataclass
class Arrival:
    index: int
    due_s: float            # seconds from the window's start (< 0: pre-roll)
    prompt: int
    output: int
    segment: str            # "pre", "window" or "post"


def _loguniform(n: int, lo: int, hi: int) -> List[int]:
    a, b = math.log(lo), math.log(hi)
    return [int(round(math.exp(a + (i + 0.5) / n * (b - a))))
            for i in range(n)]


def _permute(values: list, g: torch.Generator) -> list:
    return [values[i] for i in torch.randperm(len(values), generator=g)]


def _segment(n: int, span_s: float, start_s: float, traffic: dict,
             g: torch.Generator, name: str, first: int) -> List[Arrival]:
    if n <= 0:
        return []
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    gaps = _permute(gaps, g)
    scale = span_s / sum(gaps)
    p = traffic["prompt_tokens"]
    o = traffic["output_tokens"]
    prompts = _permute(_loguniform(n, p["lo"], p["hi"]), g)
    outputs = _permute(_loguniform(n, o["lo"], o["hi"]), g)
    out, t = [], start_s
    for i in range(n):
        out.append(Arrival(first + i, t, prompts[i], outputs[i], name))
        t += gaps[i] * scale
    return out


def serve_schedule(traffic: dict, rate: float, seconds: float,
                   seed: int) -> List[Arrival]:
    """Every arrival of a run, in due order."""
    kinds = (traffic.get("arrivals", "poisson"),
             traffic["prompt_tokens"].get("dist", "loguniform"),
             traffic["output_tokens"].get("dist", "loguniform"))
    if kinds != ("poisson", "loguniform", "loguniform"):
        raise ValueError(f"the generator makes Poisson arrivals and "
                         f"log-uniform lengths, not {kinds}")
    g = _gen(seed, 2)
    pre_s, post_s = float(traffic["preroll_s"]), float(traffic["drain_s"])
    pre = _segment(int(round(rate * pre_s)), pre_s, -pre_s, traffic, g,
                   "pre", 0)
    win = _segment(int(round(rate * seconds)), seconds, 0.0, traffic, g,
                   "window", len(pre))
    post = _segment(int(round(rate * post_s)), post_s, seconds, traffic, g,
                    "post", len(pre) + len(win))
    return pre + win + post


def prompt_ids(arrivals: List[Arrival], vocab: int, seed: int) -> List[list]:
    """Each arrival's prompt: token ids uniform over the vocabulary."""
    total = sum(a.prompt for a in arrivals)
    flat = torch.randint(0, vocab, (total,), generator=_gen(seed, 3)).tolist()
    out, pos = [], 0
    for a in arrivals:
        out.append(flat[pos:pos + a.prompt])
        pos += a.prompt
    return out
