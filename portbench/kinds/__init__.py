"""One module a traffic kind, which runs its cells: ``decentralized_train``."""
