"""Serving layer: the device-resident model bank (`model_bank`), the
port of `onix/serving/`."""
