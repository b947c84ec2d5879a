"""Models of the port: functional layers (``layers``), GQA attention
(``attention``) and the decoder LM assembly (``lm``), dense family only."""
