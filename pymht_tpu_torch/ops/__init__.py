"""Array ops of the port: Kalman primitives, K1 (gate and score), the
auction assignment, the LP / branch-and-bound solver."""
