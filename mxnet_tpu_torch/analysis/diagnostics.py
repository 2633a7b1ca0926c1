"""Diagnostics: typed findings with node-level provenance.

Counterpart of ``mxnet_tpu/analysis/diagnostics.py``.  The reference
framework surfaces graph errors as a bare ``MXNetError`` thrown from
deep inside bind/dispatch (c_api_symbolic.cc unwinds the C++ stack into
one string); Relay/TVM instead attach a span to every IR node so a
failing pass can say *where*.  Our Symbol nodes carry stable names
(NameManager), which play the role of spans: every diagnostic pins the
node it is about plus the input-variable path that feeds it, so "rank
mismatch" becomes "rank mismatch at `fc1` flowing from `data` via
`conv0`".
"""
from __future__ import annotations

import hashlib

from ..base import MXNetError

__all__ = ["Severity", "Diagnostic", "Report", "AnalysisError",
           "hazard_fingerprint"]


def hazard_fingerprint(node, op, message):
    """Stable 8-hex fingerprint of one finding's identity (node, op,
    message head).  The serving engine keeps its retrace-linter
    findings under these keys (``ServingEngine.hazard_fingerprints``),
    and the JAX package computes the same key for the same finding, so
    a finding can be matched across the two packages."""
    head = (message or "").split(":")[0]
    return hashlib.sha1(
        ("%s|%s|%s" % (node, op, head)).encode()).hexdigest()[:8]


class AnalysisError(MXNetError):
    """Raised by ``Report.raise_if_errors`` in strict mode; the message
    is the formatted report, so the failing node names survive into the
    exception text."""


class Severity(object):
    ERROR = "error"       # graph is malformed / provably unsound
    WARNING = "warning"   # likely-unintended behaviour (retrace storm,
    #                       pad contamination, host sync in a hot path)
    INFO = "info"         # observations (program-count estimates, ...)

    _ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


class Diagnostic(object):
    """One finding, pinned to a node.

    ``provenance`` is a chain of node names from a graph input to the
    node (producer path), so messages read as a dataflow trace rather
    than a lone name.
    """
    __slots__ = ("severity", "pass_name", "node", "op", "message",
                 "provenance")

    def __init__(self, severity, pass_name, message, node=None, op=None,
                 provenance=()):
        self.severity = severity
        self.pass_name = pass_name
        self.message = message
        self.node = node            # node name, or None for graph-level
        self.op = op                # op name, or None for variables
        self.provenance = tuple(provenance)

    def __str__(self):
        loc = ""
        if self.node is not None:
            loc = " @ %s" % self.node
            if self.op:
                loc += " (%s)" % self.op
        via = ""
        if self.provenance:
            via = "  [%s]" % " -> ".join(self.provenance)
        return "[%s] %s%s: %s%s" % (self.severity, self.pass_name, loc,
                                    self.message, via)

    def __repr__(self):
        return "<Diagnostic %s>" % self

    def to_dict(self):
        """JSON-ready form; ``fingerprint`` is the engine's hazard
        key."""
        return {"severity": self.severity, "pass": self.pass_name,
                "node": self.node, "op": self.op,
                "message": self.message,
                "provenance": list(self.provenance),
                "fingerprint": hazard_fingerprint(self.node, self.op,
                                                  self.message)}


class Report(object):
    """Ordered collection of diagnostics from one or more passes."""

    def __init__(self, diagnostics=()):
        self.diagnostics = list(diagnostics)

    # -- building ----------------------------------------------------------
    def add(self, diag):
        self.diagnostics.append(diag)
        return diag

    def extend(self, diags):
        self.diagnostics.extend(diags)
        return self

    # -- querying ----------------------------------------------------------
    def __len__(self):
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def by_severity(self, severity):
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self):
        return self.by_severity(Severity.ERROR)

    @property
    def warnings(self):
        return self.by_severity(Severity.WARNING)

    def by_pass(self, pass_name):
        return [d for d in self.diagnostics if d.pass_name == pass_name]

    @property
    def ok(self):
        """No errors (warnings/infos allowed)."""
        return not self.errors

    def clean(self, strict=False):
        """Nothing to report at the chosen bar: strict counts warnings
        as failures (the CLI ``--strict`` contract)."""
        return not self.errors and not (strict and self.warnings)

    # -- output ------------------------------------------------------------
    def format(self, min_severity=Severity.INFO):
        keep = Severity._ORDER[min_severity]
        lines = [str(d) for d in sorted(
            self.diagnostics, key=lambda d: Severity._ORDER[d.severity])
            if Severity._ORDER[d.severity] <= keep]
        if not lines:
            return "graph analysis: clean"
        head = "graph analysis: %d error(s), %d warning(s)" % (
            len(self.errors), len(self.warnings))
        return "\n".join([head] + ["  " + ln for ln in lines])

    def __str__(self):
        return self.format()

    def to_list(self):
        """Every diagnostic as a JSON-ready dict."""
        return [d.to_dict() for d in self.diagnostics]

    def failing_passes(self, strict=False):
        """Names of the passes whose findings fail the bar, sorted."""
        bad = list(self.errors) + (list(self.warnings) if strict else [])
        return sorted({d.pass_name for d in bad})

    def raise_if_errors(self, strict=False):
        """Raise :class:`AnalysisError` when the report fails the bar
        (errors always; warnings too under ``strict``).  The exception
        message leads with the originating pass names, so a caller
        catching it one frame up can tell a verifier failure from a
        padding refusal without parsing the findings."""
        if not self.clean(strict=strict):
            raise AnalysisError("analysis pass(es) %s failed:\n%s" % (
                ", ".join(self.failing_passes(strict=strict)) or "?",
                self.format(Severity.WARNING if strict
                            else Severity.ERROR)))
        return self
