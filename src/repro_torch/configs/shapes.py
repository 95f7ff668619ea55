"""Assigned input shapes and the (arch x shape) cell matrix: own copy of
``repro.configs.shapes``, equal field by field.

Four shapes per arch:
  train_4k     seq 4096,  global_batch 256   -> train_step
  prefill_32k  seq 32768, global_batch 32    -> prefill_step
  decode_32k   seq 32768, global_batch 128   -> serve_step (1 new token,
                                                seq_len KV cache)
  long_500k    seq 524288, global_batch 1    -> serve_step; ONLY for
                                                sub-quadratic archs

long_500k is skipped for pure full-attention archs (granite, llama3-405b,
codeqwen, olmo, llama4-scout, vision, whisper) and runs for rwkv6 /
recurrentgemma / mixtral (SWA-bounded cache).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    def scaled(self, seq: int | None = None, batch: int | None = None
               ) -> "ShapeSpec":
        return ShapeSpec(self.name, self.kind, seq or self.seq_len,
                         batch or self.global_batch)


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    """None if the cell runs; else a one-line reason recorded per cell
    (the reference's words)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return ("full-attention arch: 500k decode needs sub-quadratic "
                "attention (DESIGN.md §5)")
    return None


def cells(cfg: ModelConfig) -> list[tuple[ShapeSpec, str | None]]:
    return [(s, skip_reason(cfg, s)) for s in SHAPES.values()]
