"""One reader a metric, in a file named as the metric: ``read(record)``
gives its value from the run's record, or None when the run holds
nothing to read, and the metric is then left out of the result.

The record: ``cell`` (the workload file), ``problem`` (the inputs),
``stats`` (the task's ``stats`` of the inputs: n, nnz, nnz_b
for ``partial_hevp``), ``phases`` (the seconds of each
part of the set-up), ``peaks`` (the card's row of ``peaks.json``, None
off the card), ``setup_s``, ``walls`` (each solve's seconds) and
``window_s`` of a measured window, ``trace`` (``tracing.Trace``) of a
traced run, and ``iterations`` (each judged solve's count, as
its task's solve gives it: ``partial_hevp`` prints it)."""
