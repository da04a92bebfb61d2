"""cxxnet-style ``.conf`` grammar: tokenizer, pair stream, section splitting.

The port's own copy of the parser in ``cxxnet_tpu/config.py`` (the port
imports nothing of the JAX package).  The whole framework is driven by
a single *ordered* stream of ``name = value`` pairs read from a config
file plus CLI overrides.  Order is semantic:

* ``data = <tag>`` / ``eval = <tag>`` / ``pred = <file>`` open an iterator
  section that runs until ``iter = end``; everything inside belongs to that
  iterator chain.
* ``netconfig = start`` .. ``netconfig = end`` delimits the layer graph;
  inside it, keys following a ``layer[...] = ...`` line bind to that layer.
* ``tenant = <name>`` .. ``tenant = end`` blocks hold one tenant's keys
  (``task=loop_fleet``; :func:`split_tenant_sections`).
* everything else is a global default applied to every layer / updater /
  iterator.

Grammar:

* tokens are separated by spaces / tabs / newlines
* ``#`` starts a comment running to end of line
* ``"..."`` is a single-line string token (backslash escapes, no newlines)
* ``'...'`` is a multi-line string token (backslash escapes)
* ``=`` is always its own token
* a setting is the token triplet ``name = value`` on one logical line
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

ConfigEntry = Tuple[str, str]


class ConfigError(ValueError):
    """Malformed configuration text."""


_EQ = object()       # sentinel token: bare '='
_NEWLINE = object()  # sentinel token: logical line break


def _tokenize(text: str) -> Iterator[object]:
    """Yield string tokens, ``_EQ`` for '=', and ``_NEWLINE`` markers.

    Newline markers are emitted between lines (collapsed) so the pair
    assembler can enforce that ``name = value`` does not span lines.
    """
    i, n = 0, len(text)
    buf: List[str] = []
    pending_newline = False
    out: List[object] = []  # emit queue drained by the outer loop

    def emit(tok: object) -> None:
        nonlocal pending_newline
        if pending_newline:
            out.append(_NEWLINE)
            pending_newline = False
        out.append(tok)

    def flush() -> None:
        nonlocal buf
        if buf:
            emit("".join(buf))
            buf = []

    while i < n:
        ch = text[i]
        if ch == "#":
            while i < n and text[i] not in "\r\n":
                i += 1
            continue
        if ch in "\r\n":
            flush()
            pending_newline = True
            i += 1
        elif ch in " \t":
            flush()
            i += 1
        elif ch == "=":
            flush()
            emit(_EQ)
            i += 1
        elif ch in "\"'":
            if buf:
                raise ConfigError("string literal may not directly follow a token")
            quote = ch
            i += 1
            s: List[str] = []
            while True:
                if i >= n:
                    raise ConfigError("unterminated string literal")
                c = text[i]
                if c == "\\":
                    if i + 1 >= n:
                        raise ConfigError("unterminated string escape")
                    s.append(text[i + 1])
                    i += 2
                    continue
                if c == quote:
                    i += 1
                    break
                if quote == '"' and c in "\r\n":
                    raise ConfigError("unterminated single-line string")
                s.append(c)
                i += 1
            emit("".join(s))
        else:
            buf.append(ch)
            i += 1
        yield from out
        out.clear()
    flush()
    yield from out


def parse_pairs(text: str) -> List[ConfigEntry]:
    """Parse config text into an ordered list of ``(name, value)`` pairs."""
    out: List[ConfigEntry] = []
    name = None
    have_eq = False
    for tok in _tokenize(text):
        if tok is _NEWLINE:
            if name is not None and not have_eq:
                raise ConfigError(f"dangling token {name!r}: expected '=' on same line")
            if have_eq:
                raise ConfigError(f"missing value for {name!r}")
            continue
        if tok is _EQ:
            if name is None:
                raise ConfigError("'=' without a preceding name")
            if have_eq:
                raise ConfigError(f"duplicate '=' after {name!r}")
            have_eq = True
            continue
        if name is None:
            name = tok
        elif have_eq:
            out.append((name, tok))
            name, have_eq = None, False
        else:
            raise ConfigError(f"expected '=' after {name!r}, got {tok!r}")
    if name is not None:
        raise ConfigError(f"dangling token {name!r} at end of config")
    return out


def parse_file(path: str) -> List[ConfigEntry]:
    with open(path, "r", encoding="utf-8") as f:
        return parse_pairs(f.read())


def parse_cli_overrides(args: Sequence[str]) -> List[ConfigEntry]:
    """``name=value`` command-line overrides, appended after the file entries."""
    out: List[ConfigEntry] = []
    for a in args:
        if "=" in a:
            name, val = a.split("=", 1)
            if name and val:
                out.append((name.strip(), val.strip()))
    return out


@dataclasses.dataclass
class IteratorSection:
    """One ``data``/``eval``/``pred`` iterator section from the config."""

    kind: str                  # 'data' | 'eval' | 'pred'
    tag: str                   # eval name, or pred output filename
    entries: List[ConfigEntry]


@dataclasses.dataclass
class SplitConfig:
    """Config split into iterator sections and the remaining global stream."""

    global_entries: List[ConfigEntry]
    sections: List[IteratorSection]

    def find(self, kind: str) -> List[IteratorSection]:
        return [s for s in self.sections if s.kind == kind]


def split_sections(cfg: Sequence[ConfigEntry]) -> SplitConfig:
    """Split the ordered stream into iterator sections and global entries:
    ``data``/``eval``/``pred`` open a section, ``iter = end`` closes it,
    everything outside sections (the netconfig block included) is a
    global entry."""
    global_entries: List[ConfigEntry] = []
    sections: List[IteratorSection] = []
    mode = 0  # 0 global, else open section
    tag = ""
    cur: List[ConfigEntry] = []
    kind_of = {1: "data", 2: "eval", 3: "pred"}
    for name, val in cfg:
        if name in ("data", "eval", "pred"):
            if mode != 0:
                raise ConfigError(
                    f"'{name} = {val}' opens a new iterator section while the "
                    f"previous '{kind_of[mode]}' section is missing 'iter = end'"
                )
            mode = {"data": 1, "eval": 2, "pred": 3}[name]
            tag, cur = val, []
            continue
        if name == "iter" and val == "end":
            if mode == 0:
                raise ConfigError("'iter = end' outside an iterator section")
            sections.append(IteratorSection(kind_of[mode], tag, cur))
            mode, tag, cur = 0, "", []
            continue
        if mode == 0:
            global_entries.append((name, val))
        else:
            cur.append((name, val))
    if mode != 0:
        raise ConfigError("iterator section not closed by 'iter = end'")
    return SplitConfig(global_entries, sections)


def cfg_get(cfg: Sequence[ConfigEntry], name: str, default: str | None = None) -> str | None:
    """Last-wins lookup of a key in an ordered entry stream."""
    out = default
    for n, v in cfg:
        if n == name:
            out = v
    return out


@dataclasses.dataclass
class TenantSection:
    """One ``tenant = <name>`` .. ``tenant = end`` block: the tenant's
    ``model_dir``, feedback-log location and overrides of the shared
    loop, publish and iterator keys (applied after the shared entries,
    so the last entry wins)."""

    name: str
    entries: List[ConfigEntry]


def split_tenant_sections(
    cfg: Sequence[ConfigEntry],
) -> Tuple[List[ConfigEntry], List[TenantSection]]:
    """Take the ``tenant = <name>`` .. ``tenant = end`` blocks out of the
    ordered stream: ``(remaining_entries, tenant_sections)``.  A tenant's
    effective config is ``remaining + section.entries``
    (``loop/tenant.py``); an iterator or netconfig section may not open
    inside a tenant block.  The errors are the JAX package's."""
    rest: List[ConfigEntry] = []
    tenants: List[TenantSection] = []
    cur: List[ConfigEntry] | None = None
    cur_name = ""
    seen = set()
    for name, val in cfg:
        if name == "tenant":
            if val == "end":
                if cur is None:
                    raise ConfigError("'tenant = end' outside a tenant section")
                tenants.append(TenantSection(cur_name, cur))
                cur, cur_name = None, ""
            else:
                if cur is not None:
                    raise ConfigError(
                        f"'tenant = {val}' opens a new tenant section while "
                        f"[tenant:{cur_name}] is missing 'tenant = end'")
                if not val or val in seen:
                    raise ConfigError(
                        f"tenant name {val!r} is empty or duplicated")
                seen.add(val)
                cur, cur_name = [], val
            continue
        if cur is not None:
            if name in ("data", "eval", "pred", "netconfig"):
                raise ConfigError(
                    f"'{name} = {val}' inside [tenant:{cur_name}]: tenants "
                    "override the shared sections' keys, they do not open "
                    "their own sections")
            cur.append((name, val))
        else:
            rest.append((name, val))
    if cur is not None:
        raise ConfigError(
            f"tenant section [tenant:{cur_name}] not closed by 'tenant = end'")
    return rest, tenants
