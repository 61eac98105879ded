"""Stereo models: one file a model, named as the ``model`` a configuration
(portbench/configs/<config>.json) gives.  A configuration without one is
refused.  Each file holds what belongs to its model alone:

- ``NUMBERS``: the numbers the model's own pieces are judged on, besides
  check.COMMON and the job kind's;
- ``build(cfg, ims, device, control=None) -> (dm, proposals)``: the
  program's model (a ``DispMap`` of stereo_tpu_torch, at its start field)
  and its proposal fields [4, H, W] in the configuration's order;
  ``control`` is what the control run hands the program in place of a
  piece of its own (``control(ref)`` makes it);
- ``view(dm) -> dict``: the program's own pieces that ``judge`` reads,
  taken before the program's state is freed;
- ``Reference(cfg, ims, device)``: the plain reference, float64, importing
  nothing of the program and taking nothing it made, with
  - ``start``: the start field [4, H, W] the program restarts from, and
    ``field(k)``: proposal k as a [4, H, W] field;
  - ``energy(planes)``: the energy of a plane field [4, H, W];
  - ``candidates()``: the [4, H, W] fields a final labelling may take at
    each pixel (check.py's ``labels``);
  - ``unary(field)`` [H, W], ``edge_weights()`` [4, H, W] (0 where the
    tail of an edge lies outside the image), ``tol`` and ``normalize``
    ((d_min, d_step) or None): the terms of the reference's fusion move
    (reference/fusion.py), in the model's units (reference/planes.py);
  - ``label_problem(planes) -> (theta, D0, Q, alphas, tol)``: the K-label
    problem whose label k is the field planes[k], for the certified bound
    (reference/trws.py);
- ``judge(ref, program, order) -> dict``: the model's NUMBERS for the
  program's pieces (``program``: ``view``'s, the "start" field and the
  "proposals" in the jobs' ``order``);
- ``readings(ref, program, order) -> dict``: the raw readings behind those
  numbers that calibrate.py prints;
- ``control(ref)``: the control's hand-over to ``build``: the reference
  in the program's place, in the next precision down.

A new model is a new file here and its reference's files; no other file of
the benchmark names one."""
