"""The port's native data-plane: ``dataplane.cpp`` and its build
(``build.py``); bound by :mod:`sprc_tpu_torch.data.native`."""
