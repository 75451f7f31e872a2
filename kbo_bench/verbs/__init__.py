"""One module per verb a traffic mix can name: how the port serves one
request, how the plain reference answers it, and how two answers compare."""
