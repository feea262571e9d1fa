"""Measurement tools of the port: timers for a kernel on the card, and
side-by-side timing of kernel builds."""
