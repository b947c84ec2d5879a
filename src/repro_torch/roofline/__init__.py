"""The roofline of the port: H100 figures, collective records and the three-term model."""
