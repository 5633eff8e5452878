"""One driver per kind of traffic: ``train`` and ``serve``. A traffic file
names its driver; a driver's ``run(ctx)`` makes the set-up, the measured
window and the comparison with the plain reference, and returns a
``harness.Outcome``."""
