"""Training of the port (the counterpart of :mod:`repro.train`): the
train step, the gradient compressor and the fault-tolerant trainer."""
