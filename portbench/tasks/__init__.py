"""One module a kind of solve, named by a workload's ``task`` key
(``partial_hevp`` where the workload names none).  Each gives:

* ``Program(cell, problem, device=None, control=None)``: the program's
  set-up of one problem; ``.solve()`` runs one timed call and returns a
  SimpleNamespace with ``status``, ``iterations`` (None where the solve
  has none) and ``x``, whatever is large in the answer, which the
  window keeps for a few solves alone;
* ``stats(problem)``: what the metrics' readers and the rooflines need
  of the inputs (the record's ``stats``);
* ``NUMBERS``: the names of its checks, each held to the limit of that
  name in the workload file;
* ``judge(cell, problem, solves, device)``: (numbers, failed, reasons)
  of the solves against the configuration's plain reference, which it
  calls itself."""
