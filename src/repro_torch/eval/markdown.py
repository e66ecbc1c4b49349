"""Deterministic markdown table rendering + marker-based docs injection.

Rendering is pure formatting of row dicts — same rows always yield the
same bytes, so the artifacts of ``python -m repro_torch.eval`` render to
the same tables wherever they are rendered.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# A column is (row key, header, format spec or None). None formats with
# str(); a spec like ".3f" goes through format(value, spec). Missing or
# None values render as an em dash.
Column = Tuple[str, str, Optional[str]]

NA = "—"


def format_cell(value, spec: Optional[str]) -> str:
    if value is None:
        return NA
    if spec is None:
        return str(value)
    return format(value, spec)


def markdown_table(rows: Sequence[Dict], columns: Sequence[Column]) -> str:
    """Render rows as a GitHub-flavored markdown table (trailing \\n)."""
    headers = [h for _, h, _ in columns]
    lines = ["| " + " | ".join(headers) + " |",
             "| " + " | ".join("---" for _ in headers) + " |"]
    for row in rows:
        cells = [format_cell(row.get(key), spec) for key, _, spec in columns]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


def begin_marker(name: str) -> str:
    return f"<!-- eval:{name}:begin -->"


def end_marker(name: str) -> str:
    return f"<!-- eval:{name}:end -->"


def extract_block(text: str, name: str) -> Optional[str]:
    """Content between the named markers, or None if absent."""
    b, e = begin_marker(name), end_marker(name)
    if b not in text or e not in text:
        return None
    start = text.index(b) + len(b)
    return text[start:text.index(e, start)]


def inject_block(text: str, name: str, content: str) -> str:
    """Replace the named marker block's content (markers preserved)."""
    b, e = begin_marker(name), end_marker(name)
    if b not in text or e not in text:
        raise ValueError(f"markers for block {name!r} not found")
    start = text.index(b) + len(b)
    end = text.index(e, start)
    return text[:start] + "\n" + content + text[end:]


def block_names(text: str) -> List[str]:
    """All block names with a begin marker in the document, in order."""
    import re
    return re.findall(r"<!-- eval:([\w.-]+):begin -->", text)
