"""Rows and queries from the seed, drawn on the device.

The draw follows ``vector_db_torch/bench.py``'s ``make_corpus``: standard
normal values from a ``torch.Generator`` on the device, and for the
``spectral`` distribution dimension i scaled by (i + 1)^-0.5 (a power-law
eigenspectrum, as embedding models emit).  Rows and queries come from two
generators seeded from ``(seed, stream)``, and rows are drawn in chunks of
``DRAW_CHUNK`` in place, so the same seed gives the same values whenever
they are drawn again (the reference draws the rows a second time after the
window, once the program's state is freed).
"""

from __future__ import annotations

import numpy as np
import torch

#: rows drawn per call of the generator
DRAW_CHUNK = 1 << 17
ROW_STREAM, QUERY_STREAM, ORDER_STREAM, CHECK_STREAM = 0, 1, 2, 3


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each (run seed, stream); any whole
    number is a valid run seed."""
    seq = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(stream_seed(seed, stream))


def _scale(dim: int, distribution: str, device):
    if distribution == "spectral":
        return (torch.arange(dim, device=device, dtype=torch.float32)
                + 1.0) ** -0.5
    if distribution != "gaussian":
        raise ValueError(f"unknown row distribution {distribution!r}")
    return None


def _draw(block: torch.Tensor, gen: torch.Generator, scale) -> None:
    block.normal_(generator=gen)
    if scale is not None:
        block.mul_(scale)


def _fill(out: torch.Tensor, seed: int, stream: int,
          distribution: str) -> torch.Tensor:
    """Fill ``out`` [n, dim] in place, ``DRAW_CHUNK`` rows a call."""
    gen = _generator(seed, stream, out.device)
    scale = _scale(out.shape[1], distribution, out.device)
    for a in range(0, out.shape[0], DRAW_CHUNK):
        _draw(out[a:a + DRAW_CHUNK], gen, scale)
    return out


def draw_rows(config: dict, seed: int, device) -> torch.Tensor:
    """The deployment's [rows, dim] f32 corpus on ``device``; row i has
    id i."""
    out = torch.empty(config["rows"], config["dim"], dtype=torch.float32,
                      device=device)
    return _fill(out, seed, ROW_STREAM, config["row_distribution"])


def row_chunks(config: dict, seed: int, device, chunk_rows: int):
    """The rows of :func:`draw_rows`, the same values, as (first row,
    [m, dim] block) pairs of at most ``chunk_rows`` rows, drawn one
    ``DRAW_CHUNK`` at a time: for ingest paths whose callers hand the
    database a corpus piece by piece."""
    n, dim = config["rows"], config["dim"]
    gen = _generator(seed, ROW_STREAM, device)
    scale = _scale(dim, config["row_distribution"], device)
    for a in range(0, n, DRAW_CHUNK):
        block = torch.empty(min(DRAW_CHUNK, n - a), dim, dtype=torch.float32,
                            device=device)
        _draw(block, gen, scale)
        for b in range(0, block.shape[0], chunk_rows):
            yield a + b, block[b:b + chunk_rows]


def draw_queries(config: dict, n: int, seed: int, device) -> np.ndarray:
    """[n, dim] f32 queries of the rows' distribution, drawn on ``device``
    and handed over as a host array, as the API's callers hold them."""
    out = torch.empty(n, config["dim"], dtype=torch.float32, device=device)
    _fill(out, seed, QUERY_STREAM, config["row_distribution"])
    return np.ascontiguousarray(out.cpu().numpy())


def fingerprint(rows: torch.Tensor) -> tuple[float, float]:
    """Two sums of the rows in float64, taken chunk by chunk: a second draw
    that gives other values gives other sums (:func:`same_rows`)."""
    total = first = 0.0
    for a in range(0, rows.shape[0], DRAW_CHUNK):
        chunk = rows[a:a + DRAW_CHUNK]
        total += float(chunk.sum(dtype=torch.float64))
        first += float(chunk[:, 0].sum(dtype=torch.float64))
    return total, first


def same_rows(fp_a, fp_b) -> bool:
    """Two fingerprints of the same values, summed in other orders (whole,
    or chunk by chunk as an ingest hands them over), agree to rounding."""
    return bool(np.allclose(fp_a, fp_b, rtol=1e-9, atol=1e-6))
