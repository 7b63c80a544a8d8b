"""One driver per configuration entry: set-up, a request, and the check
of what the requests made against the plain reference."""
