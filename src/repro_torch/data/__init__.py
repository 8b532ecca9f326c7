from .synthetic import (  # noqa: F401
    TokenStream,
    dirichlet_partition,
    logreg_dataset,
    logreg_dataset_dirichlet,
    logreg_loss_and_grad,
    token_stream_for,
)
