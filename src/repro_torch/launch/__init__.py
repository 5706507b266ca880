"""Launchers of the port: model construction and step functions
(:mod:`.steps`) and the fault-tolerant server (:mod:`.serve`)."""
