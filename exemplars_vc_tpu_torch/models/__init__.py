"""The neural warping net (``nn.LSTM`` + linear head) and its trainer."""
