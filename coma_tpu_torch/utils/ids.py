"""Random asset-id strings (reference: ``utils/generate_id.py``).

A copy of ``coma_tpu/utils/ids.py``."""
from __future__ import annotations

import random
import string


def generate_id(length: int = 32, rng: random.Random = None) -> str:
    r = rng or random
    return "".join(r.choices(string.ascii_lowercase + string.digits, k=length))
