"""Run-header logging: the configuration in a box, and device memory.

Port of ``hierdiff_tpu/utils/log.py``. ``print_config`` writes the same box
around a YAML body that ``yaml.safe_load`` reads back to the configuration's
dict; it writes the YAML itself, since the card's machine has no PyYAML.
The memory figures come from ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional

import torch

# a string that YAML 1.1 (PyYAML) reads back as itself when written plain
_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*")
_YAML_WORDS = {"y", "Y", "yes", "Yes", "YES", "n", "N", "no", "No", "NO", "true", "True",
               "TRUE", "false", "False", "FALSE", "on", "On", "ON", "off", "Off", "OFF",
               "null", "Null", "NULL"}


def _scalar(v: Any) -> str:
    """One YAML scalar as ``yaml.safe_dump`` writes it."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        # YAML 1.1 reads an exponent as a float only after a '.'
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    text = str(v)
    if _PLAIN.fullmatch(text) and text not in _YAML_WORDS:
        return text
    return "'" + text.replace("'", "''") + "'"


def _yaml_lines(obj: Any, indent: int) -> List[str]:
    """Block-style YAML of nested dicts, lists and scalars (lists under a key
    at the key's indent, as PyYAML writes them)."""
    pad = " " * indent
    lines = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, dict) and v:
                lines += [f"{pad}{k}:"] + _yaml_lines(v, indent + 2)
            elif isinstance(v, (list, tuple)) and v:
                lines += [f"{pad}{k}:"] + _yaml_lines(v, indent)
            else:
                lines.append(f"{pad}{k}: {_flow(v)}")
    else:
        for v in obj:
            if isinstance(v, (dict, list, tuple)) and v:
                sub = _yaml_lines(v, indent + 2)
                lines += [f"{pad}- {sub[0].lstrip()}"] + sub[1:]
            else:
                lines.append(f"{pad}- {_flow(v)}")
    return lines


def _flow(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def print_config(cfg: Any, title: str = "Config") -> str:
    """Boxed YAML dump of the config dataclass tree; returns the text."""
    lines = _yaml_lines(dataclasses.asdict(cfg), 0)
    width = max(len(title) + 2, *(len(ln) for ln in lines)) + 2
    out = [f"+-- {title} " + "-" * max(0, width - len(title) - 4) + "+"]
    out += [f"| {ln.ljust(width - 2)} |" for ln in lines]
    out.append("+" + "-" * width + "+")
    text = "\n".join(out)
    print(text, flush=True)
    return text


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The caching allocator's byte counts for one CUDA device (default the
    current one), or None for a CPU device or without CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory)}


def log_device_stats() -> None:
    """One-line memory summary per visible CUDA device."""
    if not torch.cuda.is_available():
        print("[mem] cpu: stats unavailable", flush=True)
        return
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        s = device_memory_stats(d)
        used = s["bytes_in_use"] / 2**30
        limit = s["bytes_limit"] / 2**30
        peak = s["peak_bytes_in_use"] / 2**30
        print(f"[mem] {d}: {used:.2f} GiB in use (peak {peak:.2f}) "
              f"/ {limit:.2f} GiB", flush=True)
