"""Parser for the paper's plain-text job-definition format (§3.3).

Grammar (from the paper's sample input file)::

    J1(1,0,0), J2(2,1,0);
    J3(2,2,R1[0..5],true), J4(2,2,R1[5..10],true), J5(3,0,R1 R2),
     J6(4,0,R1 R2);
    J7(5,1, R2 R3 R4 R5);

* segments separated by ``;`` (a trailing ``;`` is allowed),
* jobs within a segment separated by ``,`` *outside parentheses*,
* each job: ``Jn(fn_id, n_threads, chunk_spec[, true|false])`` with
    - ``fn_id``      int — function identifier registered with the workers,
    - ``n_threads``  int — 0 ⇒ all available cores (paper),
    - ``chunk_spec`` ``0`` (no input) | space-separated refs ``R1 R2`` |
                     sliced ref ``R1[0..5]`` (chunks [0,5)),
    - optional 4th arg  ``true``/``false`` — no_send_back (default false).
"""
from __future__ import annotations

import re

from .job import ChunkRef, GraphValidationError, Job, JobGraph, ParallelSegment

__all__ = ["parse_job_file", "parse_job_text", "format_job_text"]

_JOB_RE = re.compile(r"^(?P<name>[A-Za-z_]\w*)\s*\((?P<args>.*)\)$", re.S)
_REF_RE = re.compile(r"^R(?P<job>\w+?)(?:\[(?P<lo>\d+)\.\.(?P<hi>\d+)\])?$")


def _split_outside_parens(text: str, sep: str) -> list[str]:
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise GraphValidationError(f"unbalanced ')' in {text!r}")
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise GraphValidationError(f"unbalanced '(' in {text!r}")
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def _parse_refs(spec: str) -> tuple[ChunkRef, ...]:
    spec = spec.strip()
    if spec == "0":
        return ()
    refs = []
    for tok in spec.split():
        m = _REF_RE.match(tok)
        if not m:
            raise GraphValidationError(f"bad chunk reference {tok!r}")
        job = "J" + m.group("job") if m.group("job").isdigit() else m.group("job")
        if m.group("lo") is not None:
            refs.append(ChunkRef(job, int(m.group("lo")), int(m.group("hi"))))
        else:
            refs.append(ChunkRef(job))
    return tuple(refs)


def _parse_job(text: str) -> Job:
    m = _JOB_RE.match(text.strip())
    if not m:
        raise GraphValidationError(f"bad job definition {text!r}")
    name = m.group("name")
    args = _split_outside_parens(m.group("args"), ",")
    if not 3 <= len(args) <= 4:
        raise GraphValidationError(
            f"{name}: expected 3 or 4 arguments, got {len(args)} in {text!r}")
    try:
        fn_id = int(args[0])
    except ValueError:
        fn_id = args[0]  # allow symbolic function names as an extension
    n_threads = int(args[1])
    inputs = _parse_refs(args[2])
    nsb = False
    if len(args) == 4:
        if args[3].lower() not in ("true", "false"):
            raise GraphValidationError(f"{name}: bad no_send_back flag {args[3]!r}")
        nsb = args[3].lower() == "true"
    return Job(name=name, fn=fn_id, n_threads=n_threads, inputs=inputs,
               no_send_back=nsb)


def parse_job_text(text: str) -> JobGraph:
    # strip comments (# ... end-of-line) — an extension for readable files
    text = re.sub(r"#[^\n]*", "", text)
    segments = []
    for seg_text in _split_outside_parens(text.replace("\n", " "), ";"):
        jobs = [_parse_job(j) for j in _split_outside_parens(seg_text, ",")]
        segments.append(ParallelSegment(jobs))
    return JobGraph(segments)


def parse_job_file(path: str) -> JobGraph:
    with open(path) as f:
        return parse_job_text(f.read())


def format_job_text(graph: JobGraph) -> str:
    """Inverse of :func:`parse_job_text` (round-trip tested)."""
    out_lines = []
    for seg in graph.segments:
        jobs = []
        for j in seg.jobs:
            spec = " ".join(
                (f"R{r.job[1:]}" if r.job.startswith("J") and r.job[1:].isdigit()
                 else f"R{r.job}")
                + ("" if r.whole else f"[{r.lo}..{r.hi}]")
                for r in j.inputs) or "0"
            args = f"{j.fn},{j.n_threads},{spec}"
            if j.no_send_back:
                args += ",true"
            jobs.append(f"{j.name}({args})")
        out_lines.append(", ".join(jobs) + ";")
    return "\n".join(out_lines)
