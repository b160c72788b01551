"""Tracing helpers of the port: so far only the NTP-style clock estimate
(``clock.py``) that the launcher's task agents use to align their clocks
with the driver's."""
