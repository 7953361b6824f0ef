"""One module a kind of traffic; each names its driver class ``DRIVER``."""
