"""Training-side host code of the port; so far the fault monitors the
serving stack uses."""
