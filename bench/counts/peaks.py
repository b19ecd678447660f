"""The table of peaks (peaks.json), looked up by the device's name."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

TABLE = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The data sheet's peaks of the chip named ``device_name``, or None
    for a chip the table does not hold (its shares are then not read)."""
    with open(TABLE) as f:
        chips = json.load(f)["chips"]
    for chip in chips:
        if chip["match"] in device_name:
            return chip
    return None


def least_seconds(flops: float, nbytes: float, peak: Dict[str, float],
                  rate: str = "bf16_flops_s") -> float:
    """The least time the chip could take: the larger of the operations at
    the compute peak and the bytes at the memory peak."""
    return max(flops / peak[rate], nbytes / peak["bytes_s"])
