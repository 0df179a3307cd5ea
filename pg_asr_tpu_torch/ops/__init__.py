"""Device ops of the port: feature frontend, LSTM layers and kernels."""
