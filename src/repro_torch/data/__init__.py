from .synthetic import TokenStream, token_stream_for  # noqa: F401
