"""Operational analytics, serving half: the HTTP server (`serve`) and
feedback capture (`feedback`), the port of `onix/oa/`."""
