"""The application layer: the solver loop, snapshots, checkpoints and
the boundary-template helper of the cases."""
