"""Models of the port: the RNN-T and its LSTM stack."""
