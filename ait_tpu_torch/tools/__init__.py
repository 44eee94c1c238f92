"""Command-line tools of the port: the train and eval CLIs."""
