"""Operations and bytes of the front-end's products, counted from shapes,
and the table of the card's peaks (``peaks.json``)."""
