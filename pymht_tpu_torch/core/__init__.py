"""The per-scan pipeline of the port: state, grow, select, lifecycle,
initiator and the host-facing Tracker."""
