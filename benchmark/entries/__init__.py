"""The entries a traffic file can drive, one file each: ``entries/<name>.py``,
found by the ``entry`` a traffic file names (:func:`benchmark.harness.spec.load_entry`).

An entry module holds everything of one kind of call:

- ``LATENCY``: the name of the end-to-end metric that is the 95th
  percentile of its calls' walls;
- ``requests(params, settings, seed, workdir, device)`` → (warm-up
  sessions, pool of sessions), each session a list of call inputs, drawn
  from the seed with :mod:`benchmark.harness.traffic`;
- ``Driver(cfg, store, data_path, params, device)``: the program prepared
  in set-up, with ``prepare_s``, ``start()`` (the callable of one
  session's calls, each returning (answer, MU steps or None)) and
  ``audio_s(item)`` (the input audio a call converts);
- ``reference(sessions, settings, params, data_path, device, tf32, built)``
  → {key: (answer, MU steps)}: the plain reference's answers to the
  sampled sessions ({key: the inputs that were called}), in float32 with
  TF32 off or, for the control, in TF32 (``built`` keeps what the
  reference built, by precision, across calls in one process);
- optionally ``observe(driver, window, pool)`` → observations that the
  per-layer readers take from a traced run.

Answers are audio, compared by :func:`benchmark.harness.check.audio_numbers`.
"""
