"""What decides a run's ``correct``: the judge its configuration names.

A configuration's file may carry ``"judge": "<name>"`` (without it,
``DEFAULT``); ``harness.resolve`` loads ``benchmark/judges/<name>.py`` by
its path and keeps the module on the cell. Each judge module brings two
things:

- ``judge(samples, cell, device, records=False) -> Verdict``: the samples
  the cell's driver kept (``Driver.judged()``; their shape is between the
  driver and the judge, the harness passes them on unread) against a plain
  reference of its own, computed after the window on the same device. With
  `records`, also the least seconds a call (``Verdict.least_s``) where the
  judge can count them.
- ``in_place_of_program(cell, device)``: a context manager that puts the
  reference, one precision below the configuration's, in the place of the
  program's entry that the cell's driver calls: the control
  (``benchmark/control.py``), which has to come out not correct.

Importing a judge module loads nothing of the program, as with
``benchmark/reference/``: the stand-in imports the entry it replaces only
when it is entered.
"""

from __future__ import annotations

import dataclasses

DEFAULT = "labels"


@dataclasses.dataclass
class Verdict:
    correct: bool
    failed: int                  # judged answers that are wrong
    compared: dict               # name -> {"value", "limit", "rule"}
    least_s: float | None = None  # the configured stages' least seconds a call
