"""Small shared helpers (reference `miso/shared/utils.py:4-5`).

Counterpart of ``podtpu/shared/utils.py``.
"""
from datetime import datetime


def now_as_str() -> str:
    """Timestamp in the reference's directory-name format."""
    return datetime.now().strftime("%Y-%m-%d_%H%M%S")
