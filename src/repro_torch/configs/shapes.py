"""Assigned input shapes (public pool) and their entry points (copy of
``repro.configs.shapes``).

  train_4k     seq_len=4096    global_batch=256   -> train_step
  prefill_32k  seq_len=32768   global_batch=32    -> serve_prefill
  decode_32k   seq_len=32768   global_batch=128   -> serve_step (1 new token,
                                                     KV cache of seq_len)
  long_500k    seq_len=524288  global_batch=1     -> serve_step, sub-quadratic
                                                     variants only
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # 'train' | 'prefill' | 'decode'


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

SHAPES: dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def get_shape(name: str) -> InputShape:
    try:
        return SHAPES[name]
    except KeyError as e:
        raise ValueError(
            f"unknown input shape {name!r}; available: {sorted(SHAPES)}"
        ) from e
