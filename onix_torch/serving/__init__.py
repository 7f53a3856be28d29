"""Serving layer: the device-resident model bank (`model_bank`), the
replica front (`replicas`) and the load harness (`load_harness`), the
port of `onix/serving/`."""
