"""One module per trainer entry point: its set-up and the call the window
repeats, found by the ``entry`` a workload names."""
