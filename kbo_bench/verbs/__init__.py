"""One module per verb a traffic mix can name: how the port serves one
request, how the plain reference answers it, and how two answers compare.
``prepare`` gets the traffic with ``"cards"``, its cell's number of cards."""
