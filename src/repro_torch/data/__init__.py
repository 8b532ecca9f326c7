from .synthetic import (TokenStream, logreg_dataset,  # noqa: F401
                        logreg_loss_and_grad, token_stream_for)
