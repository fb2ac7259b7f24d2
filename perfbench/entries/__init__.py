"""Drivers of the measured window, one module per kind of window; a traffic
mix's ``entry`` key names the module."""
