"""Java .properties-compatible reader/writer.

The port's own copy of ``webgraph_tpu/utils/properties.py``: the reference
persists graph metadata in Java properties files (ImmutableGraph.java:674-713
loads them reflectively; BVGraph.java:2490-2567 writes them).  These files
are the compatibility surface: the port parses the files shipped with
existing graphs and writes files Java can read back.

Only the subset of the Java properties syntax that the reference ever
produces/consumes is supported: ``key=value`` lines, ``#``/``!`` comments,
backslash escapes for ``:=#!`` and unicode.  ``dumps`` writes the current
date as the second comment line, as Java does.
"""

from __future__ import annotations

import time
from typing import Dict


def loads(text: str) -> Dict[str, str]:
    props: Dict[str, str] = {}
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        line = lines[i].lstrip()
        i += 1
        if not line or line[0] in "#!":
            continue
        # logical-line continuation
        while line.endswith("\\") and not line.endswith("\\\\"):
            line = line[:-1] + (lines[i].lstrip() if i < len(lines) else "")
            i += 1
        # split on first unescaped = or :
        key, sep, value = _split_kv(line)
        props[_unescape(key).strip()] = _unescape(value).strip()
    return props


def _split_kv(line: str):
    esc = False
    for j, c in enumerate(line):
        if esc:
            esc = False
            continue
        if c == "\\":
            esc = True
            continue
        if c in "=:":
            return line[:j], c, line[j + 1:]
        if c in " \t":
            # whitespace separator unless followed by = / :
            rest = line[j:].lstrip()
            if rest[:1] in "=:":
                return line[:j], rest[0], rest[1:]
            return line[:j], " ", rest
    return line, "", ""


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "u" and i + 5 < len(s):
                out.append(chr(int(s[i + 2:i + 6], 16)))
                i += 6
                continue
            out.append({"t": "\t", "n": "\n", "r": "\r", "f": "\f"}.get(nxt, nxt))
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _escape_value(s: str) -> str:
    out = []
    for c in s:
        if c in "\\=:#!":
            out.append("\\" + c)
        elif c == "\t":
            out.append("\\t")
        elif c == "\n":
            out.append("\\n")
        else:
            out.append(c)
    return "".join(out)


def dumps(props: Dict[str, str], comment: str = "") -> str:
    lines = []
    if comment:
        lines.append("#" + comment)
    lines.append("#" + time.strftime("%a %b %d %H:%M:%S %Z %Y"))
    for k, v in props.items():
        lines.append(f"{_escape_value(str(k))}={_escape_value(str(v))}")
    return "\n".join(lines) + "\n"


def load(path) -> Dict[str, str]:
    with open(path, "r", encoding="iso-8859-1") as f:
        return loads(f.read())


def dump(props: Dict[str, str], path, comment: str = "") -> None:
    with open(path, "w", encoding="iso-8859-1") as f:
        f.write(dumps(props, comment))
