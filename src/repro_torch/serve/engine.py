"""Serving configuration shared by the router, the pool and its workers.

Only ``ServeConfig`` lives here for now: the batched LM ``Engine`` of the
reference (``repro/serve/engine.py``) arrives with the port of the models.
The serving plane runs against any object with
``generate(prompts, ServeConfig)``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    eos_id: int = 1
