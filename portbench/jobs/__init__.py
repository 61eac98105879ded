"""Job kinds: one file a kind, named as the ``job`` a traffic mix
(portbench/traffic/<mix>.json) gives.  Each holds ``NUMBERS``, the numbers
its jobs are judged on besides check.COMMON and the model's (see
portbench/models/__init__.py), and a ``Job`` class:

- ``Job(dm, mix)``: the kind's hold on the program's model ``dm``;
- ``warm_up(proposals)`` and ``run(proposals)``: a short job at the cell's
  shapes, and one job from the start field (``dm.restart()`` is done by the
  caller); ``run`` returns a dict with at least ``energy``, the energy the
  program reports for its final labelling;
- ``end_to_end(jobs, elapsed)``: the kind's end-to-end metrics of a window;
- ``view()``: the program's settings the judgement needs.

and ``judge(ref, program, jobs, order)``: one dict of the kind's numbers a
job.  A new kind is a new file; the harness names none."""
