"""Continuation checkpoint/resume.

The reference carries continuation state ``(beta, solution)`` only in local
variables of ``main`` (``Driver.cu:107-109``), so a crash loses the sweep.
Here each continuation step persists a small JSON+npz record, so a
100-point sweep (BASELINE.md config 5) resumes from the last completed
step.

This is the port's own copy of the JAX package's ``utils/checkpoint.py``
(numpy only; importing it from there would pull in JAX), with the same
on-disk format: ``steps.jsonl`` (one JSON record a step) beside one
``step_<index>.npz`` payload a step.  A checkpoint written by either package
loads in the other.

Durability contract (each clause crash-tested in
tests/test_torch_checkpoint.py):

* the ``.npz`` payload is written atomically (tmp + fsync + ``os.replace``)
  BEFORE its index line is appended, so a durable index line always points
  at a complete payload from the same save;
* the index append is flushed + fsynced per record, so a kill mid-append
  leaves at most one truncated LAST line, which :meth:`load_all` skips
  (the step it described was not completed durably: resume redoes it);
* :meth:`save` newline-terminates a truncated tail before appending, so a
  post-crash re-save can never merge into the garbage line (which would
  silently drop the redone step now and poison every later load);
* a missing/corrupt payload for the LAST index entry is treated like a
  truncated tail (that step is dropped and redone); anywhere earlier it
  raises, because data loss mid-history cannot be self-healed.
"""

from __future__ import annotations

import json
import os
import pathlib
import warnings
import zipfile
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ContinuationStep:
    """One completed continuation step."""

    index: int
    beta: float
    solution: np.ndarray
    residual_norm: float
    converged: bool
    n_unstable: Optional[int] = None
    eigenvalues: Optional[np.ndarray] = None


class ContinuationCheckpoint:
    """Append-only checkpoint for a parameter sweep."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self._index_file = self.path / "steps.jsonl"

    def _npz_path(self, index: int) -> pathlib.Path:
        return self.path / f"step_{index:05d}.npz"

    def save(self, step: ContinuationStep) -> None:
        rec = {
            "index": step.index,
            "beta": step.beta,
            "residual_norm": step.residual_norm,
            "converged": step.converged,
            "n_unstable": step.n_unstable,
        }
        # Atomic payload write: tmp + fsync + rename.  The payload lands
        # durably BEFORE its index line, so a crash between the two leaves
        # an orphan npz (harmless: its index line never arrives and the
        # next save overwrites it atomically) — never a durable index line
        # pointing at a truncated payload.
        target = self._npz_path(step.index)
        tmp = target.with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, solution=step.solution,
                     eigenvalues=(step.eigenvalues
                                  if step.eigenvalues is not None
                                  else np.array([])))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)

        # Crash-safe O(1) append: write + flush + fsync per record; a kill
        # mid-write can leave at most one truncated LAST line, which
        # load_all skips (a crash between steps loses nothing).  If the
        # previous run died mid-append, the tail has no newline — terminate
        # it first so this record starts its own line (the truncated
        # fragment then parses as its own bad line, which load_all's
        # dedupe-by-index treats as superseded garbage).
        with open(self._index_file, "a") as f:
            if f.tell() > 0:
                with open(self._index_file, "rb") as g:
                    g.seek(-1, os.SEEK_END)
                    if g.read(1) != b"\n":
                        f.write("\n")
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _load_index(self) -> dict[int, dict]:
        """Parse the jsonl index: latest record per step index wins."""
        if not self._index_file.exists():
            return {}
        by_index: dict[int, dict] = {}
        lines = self._index_file.read_text().splitlines()
        for lineno, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                if lineno == len(lines) - 1:
                    # truncated tail from a crash mid-append: the step it
                    # described was not completed durably — resume redoes it
                    warnings.warn(
                        f"skipping truncated final line of "
                        f"{self._index_file} (crash mid-append)")
                    continue
                # a mid-file fragment is the tail of a run that crashed
                # mid-append; its step was re-saved right after (the next
                # line), so skipping is the lossless recovery
                warnings.warn(
                    f"skipping corrupt line {lineno + 1} of "
                    f"{self._index_file} (crash mid-append of a previous "
                    "run; the following re-saved record supersedes it)")
                continue
            # Re-running a sweep into the same directory appends a fresh
            # record per index; the latest write wins (its .npz is the
            # one on disk).
            by_index[int(rec["index"])] = rec
        return by_index

    def _load_step(self, index: int, rec: dict) -> ContinuationStep:
        data = np.load(self._npz_path(index))
        ev = data["eigenvalues"]
        return ContinuationStep(
            index=index, beta=rec["beta"],
            solution=data["solution"],
            residual_norm=rec["residual_norm"],
            converged=rec["converged"],
            n_unstable=rec.get("n_unstable"),
            eigenvalues=ev if ev.size else None)

    def load_all(self) -> list[ContinuationStep]:
        by_index = self._load_index()
        steps = []
        order = sorted(by_index)
        for pos, index in enumerate(order):
            try:
                steps.append(self._load_step(index, by_index[index]))
            except (FileNotFoundError, zipfile.BadZipFile, ValueError,
                    EOFError, OSError) as e:
                if pos == len(order) - 1:
                    # the LAST step's payload is missing/truncated (a torn
                    # disk, or a writer without the atomic save): drop it
                    # like a truncated index tail; resume redoes the step
                    warnings.warn(
                        f"dropping final checkpoint step {index}: its "
                        f"payload is unreadable ({e}); the step will be "
                        "redone on resume")
                    continue
                raise ValueError(
                    f"checkpoint payload for step {index} is unreadable "
                    f"mid-history ({self._npz_path(index)}): {e}") from e
        return steps

    def last(self) -> Optional[ContinuationStep]:
        """The latest completed step — O(1) payload loads (the index scan
        is unavoidable, but only the final step's npz is opened; a resumed
        100-point --stability sweep would otherwise unzip every
        eigenvalue array at startup).

        Mirrors :meth:`load_all`'s recovery: an unreadable FINAL payload
        is dropped (that step gets redone) and the previous step is
        returned; an unreadable payload before that is mid-history data
        loss and raises.
        """
        by_index = self._load_index()
        order = sorted(by_index, reverse=True)
        for pos, index in enumerate(order):
            try:
                return self._load_step(index, by_index[index])
            except (FileNotFoundError, zipfile.BadZipFile, ValueError,
                    EOFError, OSError) as e:
                if pos > 0:
                    raise ValueError(
                        f"checkpoint payload for step {index} is "
                        f"unreadable mid-history "
                        f"({self._npz_path(index)}): {e}") from e
                warnings.warn(
                    f"dropping final checkpoint step {index}: its payload "
                    f"is unreadable ({e}); the step will be redone on "
                    "resume")
        return None
