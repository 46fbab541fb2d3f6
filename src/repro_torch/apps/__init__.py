"""Applications built on the port's job-model runtime: the paper's §4
Jacobi solver (:mod:`.jacobi`)."""
