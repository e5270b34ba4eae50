"""Finding + baseline model for the port's contract checker (port of
``repro.audit.findings``: the same fields, fingerprint and JSON, so either
package reads a baseline the other wrote).

A :class:`Finding` is one ``file:line``-anchored violation of a
machine-checked invariant, emitted by a rule in ``trace_rules``,
``ast_rules``, ``reachability``, ``smem`` or ``harness``. Findings carry a
stable *fingerprint* — ``(rule, file, message)``, deliberately excluding
the line number — so a committed baseline keeps matching across unrelated
edits that merely shift lines.

The baseline (``src/repro_torch/audit/baseline.json``) is the mechanism
for accepting a finding permanently: every entry must carry a one-line
human justification, and ``python -m repro_torch.audit --strict`` fails on
any finding *not* in the baseline. An entry may also name the ``device``
(``"cpu"`` or ``"cuda"``) whose traces alone show the finding; a run on
another device neither matches nor reports it as stale.
"""
from __future__ import annotations

import dataclasses
import json
import os

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One contract violation, anchored to a repo-relative ``file:line``."""

    rule: str           # e.g. 'dtype-f64', 'host-sync', 'vmap-over-queue'
    severity: str       # 'error' | 'warning' | 'info'
    file: str           # repo-relative path ('-' for repo-level findings)
    line: int           # 1-based; 0 when no source anchor exists
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    @property
    def fingerprint(self) -> tuple[str, str, str]:
        """Line-insensitive identity used for baseline matching."""
        return (self.rule, self.file, self.message)

    @property
    def location(self) -> str:
        return f"{self.file}:{self.line}" if self.line else self.file

    def render(self) -> str:
        return f"{self.location}: {self.severity}[{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class BaselineError(ValueError):
    """A malformed baseline file (bad shape, missing justification)."""


class Baseline:
    """The committed set of accepted findings, each with a justification."""

    def __init__(self, entries: list[dict]):
        self.entries = entries
        self._index = {(e["rule"], e["file"], e["message"]): e
                       for e in entries}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([])
        with open(path) as f:
            try:
                data = json.load(f)
            except json.JSONDecodeError as e:
                raise BaselineError(f"{path}: not valid JSON ({e})") from None
        entries = data.get("findings")
        if not isinstance(entries, list):
            raise BaselineError(f"{path}: expected a 'findings' list")
        for e in entries:
            missing = {"rule", "file", "message"} - set(e)
            if missing:
                raise BaselineError(
                    f"{path}: baseline entry {e!r} missing {sorted(missing)}")
            if not str(e.get("justification", "")).strip():
                raise BaselineError(
                    f"{path}: baseline entry for rule {e['rule']!r} in "
                    f"{e['file']!r} has no justification — every accepted "
                    "finding must say why")
        return cls(entries)

    @classmethod
    def from_findings(cls, findings: list[Finding],
                      justification: str = "TODO: justify") -> "Baseline":
        return cls([{**{"rule": f.rule, "file": f.file, "message": f.message},
                     "justification": justification} for f in findings])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"findings": self.entries}, f, indent=2, sort_keys=True)
            f.write("\n")

    def __contains__(self, finding: Finding) -> bool:
        return finding.fingerprint in self._index

    def split(self, findings: list[Finding], device: str | None = None):
        """-> (fresh findings, baselined findings, stale baseline entries).

        With ``device``, entries that name another device are set aside:
        they match nothing and are not stale."""
        index = {k: e for k, e in self._index.items()
                 if device is None or e.get("device", device) == device}
        fresh = [f for f in findings if f.fingerprint not in index]
        matched = [f for f in findings if f.fingerprint in index]
        live = {f.fingerprint for f in matched}
        stale = [e for k, e in index.items() if k not in live]
        return fresh, matched, stale
