"""Class label record.

Parity: reference `miso/object_detection/dataset/label.py:1-5` (id/name/colour
triple).  Counterpart of ``podtpu/data/label.py``.
"""
from dataclasses import dataclass
from typing import Optional


@dataclass
class Label:
    id: Optional[int]
    name: str
    colour: Optional[str] = None

    def __str__(self) -> str:
        return f"{self.name} (id={self.id}, colour={self.colour})"
