"""Round-trip YAML editor for programmatic config sweeps (a copy of the JAX
package's ``core/yaml_editor.py``; its output is byte-equal to that one's).

Equivalent of the reference's ruamel-based ``scripts/config_parser.py``:
dotted-path (+ ``[idx]``) addressing into a YAML file, with in-place value
replacement that preserves the file's formatting and comments.  Used by the
grid-search run CLI to mutate ``config.yaml`` between trials
(reference ``run.py:80-86``).

Implemented line-based (no ruamel in this environment): only the scalar
token on the addressed line is rewritten; everything else is untouched.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple


def _fmt_scalar(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if value is None:
        return ""
    if isinstance(value, str):
        return f'"{value}"' if re.search(r"[:#\s]", value) or value == "" else value
    return repr(value)


def _parse_path(path: str) -> List[Tuple[str, Any]]:
    """``"A.B[2].C"`` -> ``[("key","A"),("key","B"),("idx",2),("key","C")]``."""
    parts: List[Tuple[str, Any]] = []
    for seg in path.split("."):
        m = re.match(r"^([^\[\]]+)((\[\d+\])*)$", seg.strip())
        if not m:
            raise ValueError(f"Bad path segment: {seg!r}")
        parts.append(("key", m.group(1)))
        for idx in re.findall(r"\[(\d+)\]", m.group(2)):
            parts.append(("idx", int(idx)))
    return parts


class ConfigParser:
    """Dotted-path YAML reader/writer preserving file formatting."""

    def __init__(self, yaml_path: str):
        import yaml

        self.yaml_path = yaml_path
        with open(yaml_path, "r", encoding="utf-8") as f:
            self.lines = f.read().splitlines(keepends=True)
        self.data = yaml.safe_load("".join(self.lines)) or {}

    # -- reading ----------------------------------------------------------
    def get_value(self, path: str) -> Any:
        node: Any = self.data
        for kind, part in _parse_path(path):
            node = node[part]
        return node

    # -- writing ----------------------------------------------------------
    def set_value(self, path: str, value: Any) -> None:
        """Set one scalar (or whole inline list element) at a dotted path."""
        parts = _parse_path(path)
        # update the parsed copy (kept consistent for get_value after set)
        node: Any = self.data
        for kind, part in parts[:-1]:
            node = node[part]
        node[parts[-1][1]] = value

        line_no, line = self._locate_line(parts)
        if parts[-1][0] == "idx":
            self.lines[line_no] = self._replace_list_elem(line, parts[-1][1], value)
        else:
            self.lines[line_no] = self._replace_scalar(line, value)

    def set_values(self, pairs) -> None:
        for path, value in pairs:
            self.set_value(path, value)

    def save(self, out_path: str | None = None) -> None:
        with open(out_path or self.yaml_path, "w", encoding="utf-8") as f:
            f.write("".join(self.lines))

    def set_yaml_value(self, path: str, value: Any) -> None:
        """Reference-compatible name: set then save in place."""
        self.set_value(path, value)
        self.save()

    def set_yaml_values(self, pairs) -> None:
        self.set_values(pairs)
        self.save()

    # -- internals --------------------------------------------------------
    def _locate_line(self, parts: List[Tuple[str, Any]]) -> Tuple[int, str]:
        """Find the file line holding the addressed key (indent-tracked)."""
        key_parts = [p for p in parts if p[0] == "key"]
        depth = 0
        indent_stack = [-1]
        for i, raw in enumerate(self.lines):
            stripped = raw.split("#", 1)[0].rstrip()
            if not stripped.strip():
                continue
            m = re.match(r"^(\s*)([A-Za-z0-9_\-]+)\s*:", stripped)
            if not m:
                continue
            indent = len(m.group(1))
            key = m.group(2)
            while indent <= indent_stack[-1]:
                indent_stack.pop()
                depth -= 1
            if depth < len(key_parts) and key == key_parts[depth][1]:
                depth += 1
                indent_stack.append(indent)
                if depth == len(key_parts):
                    return i, raw
        raise KeyError(
            "Path " + ".".join(str(p[1]) for p in key_parts) + " not found in YAML"
        )

    @staticmethod
    def _replace_scalar(line: str, value: Any) -> str:
        m = re.match(r"^(\s*[A-Za-z0-9_\-]+\s*:\s*)([^#\n]*?)(\s*(#.*)?\n?)$", line)
        if not m:
            raise ValueError(f"Cannot rewrite line: {line!r}")
        return m.group(1) + _fmt_scalar(value) + m.group(3)

    @staticmethod
    def _replace_list_elem(line: str, idx: int, value: Any) -> str:
        m = re.match(r"^(\s*[A-Za-z0-9_\-]+\s*:\s*\[)([^\]]*)(\].*\n?)$", line)
        if not m:
            raise ValueError(f"Cannot rewrite inline list on line: {line!r}")
        elems = [e.strip() for e in m.group(2).split(",")]
        if idx >= len(elems):
            raise IndexError(f"List index {idx} out of range on line: {line!r}")
        elems[idx] = _fmt_scalar(value)
        return m.group(1) + ", ".join(elems) + m.group(3)


# Reference-compatible alias (reference class name: ``Config_Parser``).
Config_Parser = ConfigParser
