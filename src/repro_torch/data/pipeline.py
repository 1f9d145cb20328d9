"""Data pipeline: deterministic, step-indexed, restart-exact (port of
``repro.data.pipeline``; numpy only, typed against the port's
``ModelConfig``).

For LM pretraining the stream is synthetic (no corpora ship with the
repo): a seeded Zipfian token sampler with injected n-gram structure, so
the loss actually decreases.  The pipeline is *stateless by
construction* — batch ``i`` is a pure function of ``(seed, i)`` — which
makes checkpoint / restart exact (no data-state file) and lets any host
materialize only its shard (``host_slice``).  The draws are the
reference's, bit for bit; the tokens stay int32 arrays, and the trainer
moves them to its device.

A background-thread prefetcher overlaps host batch synthesis with device
steps.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_alpha: float = 1.1
    ngram_order: int = 3
    ngram_prob: float = 0.6     # P(continue an n-gram template)
    n_templates: int = 2048


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synth_batch(cfg: ModelConfig, dcfg: DataConfig, step: int,
                batch: int, seq: int,
                host_slice: Optional[slice] = None) -> Dict[str, np.ndarray]:
    """Batch ``step`` of the synthetic stream (pure function of inputs).

    ``host_slice`` selects this host's rows of the global batch."""
    rng = _rng_for(dcfg.seed, step)
    v = cfg.vocab_size
    # Zipfian unigram base
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = ranks ** -dcfg.zipf_alpha
    probs /= probs.sum()
    tokens = rng.choice(v, size=(batch, seq), p=probs).astype(np.int32)
    # overlay n-gram templates (learnable structure)
    tpl_rng = _rng_for(dcfg.seed, 0x7EA11A7E)    # templates fixed per seed
    templates = tpl_rng.integers(0, v, size=(dcfg.n_templates,
                                             dcfg.ngram_order))
    starts = rng.random((batch, seq)) < dcfg.ngram_prob / dcfg.ngram_order
    tpl_ids = rng.integers(0, dcfg.n_templates, size=(batch, seq))
    for k in range(dcfg.ngram_order):
        mask = np.zeros((batch, seq), bool)
        mask[:, k:] = starts[:, :seq - k]
        ids = np.roll(tpl_ids, k, axis=1)
        tokens[mask] = templates[ids[mask], k]
    out = {"tokens": tokens}
    if cfg.vision_tokens:
        out["vision_embeds"] = rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["audio_frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if host_slice is not None:
        out = {k: x[host_slice] for k, x in out.items()}
    return out


class Prefetcher:
    """Background-thread prefetch of synth batches (overlaps with steps)."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, batch: int,
                 seq: int, start_step: int = 0, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                b = synth_batch(cfg, dcfg, step, batch, seq)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
