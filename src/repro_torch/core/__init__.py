"""gs-SGD core: Count-Sketch, HEAVYMIX, error feedback, all-reduce,
compressors and the train step."""
