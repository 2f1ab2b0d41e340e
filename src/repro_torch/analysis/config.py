"""``analysis.toml`` — per-rule allowlists and options.

Port of ``repro.analysis.config``.  The port's config file lives beside
this module (:data:`CONFIG_PATH`) and scopes *sanctioned* violations
(the retired-name mentions in CHANGES.md, the direct wall-clock reads in
the serving modules that own the clock seam), so the engines themselves
stay allowlist-free: a rule reports everything it sees, and the config
is the single audited place where exceptions live.

Python 3.10 has no ``tomllib``, and the port adds no dependencies, so a
minimal TOML-subset parser backs it up.  The subset is exactly what
``analysis.toml`` uses: ``[dotted.section]`` headers, ``key = "string"``,
``key = ["list", "of", "strings"]``, ``key = 123``, ``key = true/false``,
and ``#`` comments.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from pathlib import Path

try:
    import tomllib  # Python >= 3.11
except ModuleNotFoundError:  # pragma: no cover - Python 3.10
    tomllib = None

CONFIG_NAME = "analysis.toml"

#: The port's default config: this package's own ``analysis.toml``.
CONFIG_PATH = Path(__file__).resolve().parent / CONFIG_NAME


def _parse_toml_subset(text: str) -> dict:
    """Parse the TOML subset ``analysis.toml`` is written in.

    Fallback for Python 3.10 where ``tomllib`` is absent; intentionally
    strict — anything outside the subset raises so a config typo fails
    the analysis run instead of silently allowlisting nothing.
    """
    root: dict = {}
    table = root
    pending: tuple[str, int, list[str]] | None = None  # multi-line array
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("#", 1)[0].strip() if not raw.strip().startswith("#") \
            else ""
        if not line:
            continue
        if pending is not None:
            key, start, parts = pending
            parts.append(line)
            if line.endswith("]"):
                table[key] = _parse_value(" ".join(parts), start)
                pending = None
            continue
        if line.startswith("[") and line.endswith("]"):
            table = root
            for part in line[1:-1].strip().split("."):
                table = table.setdefault(part.strip(), {})
            continue
        if "=" not in line:
            raise ValueError(f"{CONFIG_NAME}:{lineno}: not key = value: {raw!r}")
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip()
        if value.startswith("[") and not value.endswith("]"):
            pending = (key, lineno, [value])
            continue
        table[key] = _parse_value(value, lineno)
    if pending is not None:
        raise ValueError(
            f"{CONFIG_NAME}:{pending[1]}: unterminated array for "
            f"{pending[0]!r}")
    return root


def _parse_value(value: str, lineno: int):
    if value.startswith("[") and value.endswith("]"):
        inner = value[1:-1].strip()
        if not inner:
            return []
        return [_parse_value(item.strip(), lineno)
                for item in inner.split(",") if item.strip()]
    if value.startswith('"') and value.endswith('"') and len(value) >= 2:
        return value[1:-1]
    if value in ("true", "false"):
        return value == "true"
    try:
        return int(value)
    except ValueError:
        raise ValueError(
            f"{CONFIG_NAME}:{lineno}: unsupported value {value!r} "
            "(subset: string, int, bool, list of those)") from None


@dataclass
class AnalysisConfig:
    """Loaded view of an ``analysis.toml``.

    ``allow`` maps rule id -> list of repo-relative path patterns
    (``fnmatch`` syntax, so both exact files and ``src/**`` globs work);
    ``options`` maps rule id -> its ``[rules.<id>]`` table minus the
    ``allow`` key, for rules that take parameters.
    """

    allow: dict[str, list[str]] = field(default_factory=dict)
    options: dict[str, dict] = field(default_factory=dict)

    @classmethod
    def load(cls, path: Path | str | None = None) -> "AnalysisConfig":
        """The config in the file ``path`` (default :data:`CONFIG_PATH`);
        an empty config when the file does not exist."""
        path = Path(path) if path is not None else CONFIG_PATH
        if not path.is_file():
            return cls()
        text = path.read_text(encoding="utf-8")
        if tomllib is not None:
            data = tomllib.loads(text)
        else:
            data = _parse_toml_subset(text)
        allow: dict[str, list[str]] = {}
        options: dict[str, dict] = {}
        for rule, table in data.get("rules", {}).items():
            if not isinstance(table, dict):
                raise ValueError(
                    f"{CONFIG_NAME}: [rules.{rule}] must be a table")
            entries = table.get("allow", [])
            if not isinstance(entries, list):
                raise ValueError(
                    f"{CONFIG_NAME}: rules.{rule}.allow must be a list")
            allow[rule] = [str(e) for e in entries]
            opts = {k: v for k, v in table.items() if k != "allow"}
            if opts:
                options[rule] = opts
        return cls(allow=allow, options=options)

    def allowed(self, rule: str, location: str) -> bool:
        """True when ``location`` is sanctioned for ``rule``."""
        loc = location.replace("\\", "/")
        for pattern in self.allow.get(rule, ()):
            if loc == pattern or fnmatch.fnmatch(loc, pattern):
                return True
        return False
